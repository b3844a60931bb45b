"""Interval and window bookkeeping (§III-A "foreach time interval").

The counterpart of ``repro.core.window``. Within one interval a node may
receive several messages carrying ``(W^out, C^out)`` sets: the counts sum
and the weights combine as the count-weighted mean ``Σ w_k C_k / Σ C_k``.
Across intervals the sets are sticky: items that arrive before their
metadata use the most recent ``W^in``/``C^in``. Three holders share
these rules:

* ``Window``     — one node's host (numpy) buffer: the ``loop`` engine.
* ``LevelState`` — a level's nodes stacked into ``[n_nodes, ...]`` host
  arrays: the ``level`` engine flushes a whole level into one step.
* ``TreeState``  — every level on the device: the scan engine.

All three accumulate in f32 and fold messages in child order, which is
what keeps the engines bitwise alike.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Window:
    """One node's fixed-capacity buffer and interval accumulators."""

    def __init__(self, capacity: int, num_strata: int, interval_ticks: int):
        self.capacity = int(capacity)
        self.num_strata = int(num_strata)
        self.interval_ticks = int(interval_ticks)
        # Sticky sets: most recent effective W^in / C^in per stratum.
        self.w_in = np.ones((num_strata,), np.float32)
        self.c_in = np.zeros((num_strata,), np.float32)
        self._reset()

    def _reset(self) -> None:
        self.values = np.zeros((self.capacity,), np.float32)
        self.strata = np.zeros((self.capacity,), np.int32)
        self.fill = 0
        self.dropped = 0
        # This interval's Σ w·C and Σ C per stratum (f32, message order).
        self._wc_acc = np.zeros((self.num_strata,), np.float32)
        self._c_acc = np.zeros((self.num_strata,), np.float32)
        self._seen = np.zeros((self.num_strata,), bool)

    def deliver(self, values: np.ndarray, strata: np.ndarray,
                weight: np.ndarray | None = None,
                count: np.ndarray | None = None) -> None:
        """Append items; fold the message's W/C sets into this interval
        (only for the strata the message carries items of)."""
        if weight is not None and count is not None:
            present = np.zeros((self.num_strata,), bool)
            present[np.unique(strata)] = True
            w = weight.astype(np.float32)
            c = count.astype(np.float32)
            self._wc_acc = np.where(present, self._wc_acc + w * c,
                                    self._wc_acc)
            self._c_acc = np.where(present, self._c_acc + c, self._c_acc)
            self._seen |= present
        n = len(values)
        take = min(n, self.capacity - self.fill)
        if take < n:
            self.dropped += n - take  # backpressure accounting
        self.values[self.fill:self.fill + take] = values[:take]
        self.strata[self.fill:self.fill + take] = strata[:take]
        self.fill += take

    def due(self, tick: int) -> bool:
        return tick % self.interval_ticks == 0

    def flush(self):
        """``(values, strata, valid, w_in, c_in)``, then reset: strata with
        fresh metadata use the accumulated sets, the rest the sticky ones
        (§III-C)."""
        valid = np.zeros((self.capacity,), bool)
        valid[:self.fill] = True
        w_merged = self._wc_acc / np.maximum(self._c_acc, np.float32(1.0))
        w_eff = np.where(self._seen, w_merged, self.w_in).astype(np.float32)
        c_eff = np.where(self._seen, self._c_acc, self.c_in).astype(
            np.float32)
        self.w_in, self.c_in = w_eff, c_eff
        out = (self.values.copy(), self.strata.copy(), valid,
               w_eff.copy(), c_eff.copy())
        self._reset()
        return out


class LevelState:
    """Every node of one level stacked into ``[n_nodes, ...]`` host
    arrays, with ``Window``'s interval rules; all nodes of a level share
    one interval length."""

    def __init__(self, n_nodes: int, capacity: int, num_strata: int,
                 interval_ticks: int):
        self.n_nodes = int(n_nodes)
        self.capacity = int(capacity)
        self.num_strata = int(num_strata)
        self.interval_ticks = int(interval_ticks)
        self.w_in = np.ones((self.n_nodes, self.num_strata), np.float32)
        self.c_in = np.zeros((self.n_nodes, self.num_strata), np.float32)
        self._reset()

    def _reset(self) -> None:
        n, cap, x = self.n_nodes, self.capacity, self.num_strata
        self.values = np.zeros((n, cap), np.float32)
        self.strata = np.zeros((n, cap), np.int32)
        self.fill = np.zeros((n,), np.int64)
        self.dropped = np.zeros((n,), np.int64)
        self._wc_acc = np.zeros((n, x), np.float32)
        self._c_acc = np.zeros((n, x), np.float32)
        self._seen = np.zeros((n, x), bool)

    def deliver(self, node: int, values: np.ndarray, strata: np.ndarray,
                weight: np.ndarray | None = None,
                count: np.ndarray | None = None) -> None:
        """Append items to one node; fold the message's W/C sets in."""
        if weight is not None and count is not None:
            present = np.zeros((self.num_strata,), bool)
            present[np.unique(strata)] = True
            w = weight.astype(np.float32)
            c = count.astype(np.float32)
            self._wc_acc[node] = np.where(
                present, self._wc_acc[node] + w * c, self._wc_acc[node])
            self._c_acc[node] = np.where(
                present, self._c_acc[node] + c, self._c_acc[node])
            self._seen[node] |= present
        n = len(values)
        take = min(n, self.capacity - int(self.fill[node]))
        if take < n:
            self.dropped[node] += n - take
        f = int(self.fill[node])
        self.values[node, f:f + take] = values[:take]
        self.strata[node, f:f + take] = strata[:take]
        self.fill[node] += take

    def deliver_packed(self, packed_values: np.ndarray,
                       packed_strata: np.ndarray,
                       counts: np.ndarray) -> None:
        """Append a level step's per-parent packed items: row ``p``'s
        first ``counts[p]`` slots are real (children in child order)."""
        for p in range(self.n_nodes):
            n = int(counts[p])
            take = min(n, self.capacity - int(self.fill[p]))
            if take < n:
                self.dropped[p] += n - take
            f = int(self.fill[p])
            self.values[p, f:f + take] = packed_values[p, :take]
            self.strata[p, f:f + take] = packed_strata[p, :take]
            self.fill[p] += take

    def fold_meta(self, parent_ix: np.ndarray, present: np.ndarray,
                  weight: np.ndarray, count: np.ndarray) -> None:
        """Fold per-child (W^out, C^out) messages into the parents'
        accumulators, in child order with f32 adds; ``present[j, x]``
        marks the strata child ``j`` forwarded items of."""
        w = weight.astype(np.float32)
        c = count.astype(np.float32)
        zero = np.float32(0.0)
        np.add.at(self._wc_acc, parent_ix, np.where(present, w * c, zero))
        np.add.at(self._c_acc, parent_ix, np.where(present, c, zero))
        np.logical_or.at(self._seen, parent_ix, present)

    def due(self, tick: int) -> bool:
        return tick % self.interval_ticks == 0

    def flush_all(self):
        """Stacked ``(values, strata, valid, w_in, c_in)``, then reset;
        per node the rules of ``Window.flush``."""
        valid = np.arange(self.capacity)[None, :] < self.fill[:, None]
        w_merged = self._wc_acc / np.maximum(self._c_acc, np.float32(1.0))
        w_eff = np.where(self._seen, w_merged, self.w_in).astype(np.float32)
        c_eff = np.where(self._seen, self._c_acc, self.c_in).astype(
            np.float32)
        self.w_in, self.c_in = w_eff, c_eff
        out = (self.values.copy(), self.strata.copy(), valid,
               w_eff.copy(), c_eff.copy())
        self._reset()
        return out


class TreeState(NamedTuple):
    """Every field is a tuple with one entry per level. Per level ``l``
    (``n`` nodes, capacity ``M``, ``X`` strata):

    ``values``/``strata``  f32/i32 ``[n, M]`` — item buffers; a flush
        only resets ``fill`` (slots past ``fill`` are masked everywhere).
    ``fill``/``dropped``   i32 ``[n]`` — occupancy and backpressure count.
    ``w_in``/``c_in``      f32 ``[n, X]`` — sticky W^in/C^in sets.
    ``wc_acc``/``c_acc``   f32 ``[n, X]`` — this interval's Σw·C and ΣC.
    ``seen``               bool ``[n, X]`` — strata with fresh metadata.

    ``qstate`` is the query plane's sketch state (the tenant plan's
    ``init_state``), ``()`` without tenants. ``telemetry`` is an ``obs.telemetry.EpochTelemetry`` or
    ``()``; ``route`` an i32 ``[num_keys]`` key→stratum table or ``()``.
    """

    values: tuple
    strata: tuple
    fill: tuple
    dropped: tuple
    w_in: tuple
    c_in: tuple
    wc_acc: tuple
    c_acc: tuple
    seen: tuple
    qstate: tuple = ()
    telemetry: tuple = ()
    route: tuple = ()

    LEVEL_FIELDS = ("values", "strata", "fill", "dropped", "w_in", "c_in",
                    "wc_acc", "c_acc", "seen")

    @staticmethod
    def create(fanin, capacities, num_strata: int, *, device=None,
               qstate: tuple = (), telemetry: tuple = (),
               route: tuple = ()) -> "TreeState":
        """Fresh state: empty buffers, identity metadata (W = 1, C = 0)."""
        x = num_strata

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return TreeState(
            values=tuple(zeros((n, c), torch.float32)
                         for n, c in zip(fanin, capacities)),
            strata=tuple(zeros((n, c), torch.int32)
                         for n, c in zip(fanin, capacities)),
            fill=tuple(zeros((n,), torch.int32) for n in fanin),
            dropped=tuple(zeros((n,), torch.int32) for n in fanin),
            w_in=tuple(torch.ones((n, x), dtype=torch.float32, device=device)
                       for n in fanin),
            c_in=tuple(zeros((n, x), torch.float32) for n in fanin),
            wc_acc=tuple(zeros((n, x), torch.float32) for n in fanin),
            c_acc=tuple(zeros((n, x), torch.float32) for n in fanin),
            seen=tuple(zeros((n, x), torch.bool) for n in fanin),
            qstate=qstate, telemetry=telemetry, route=route)
