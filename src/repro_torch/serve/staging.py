"""Double-buffered host staging for overlapped ingest/dispatch.

The port's own copy of ``repro.serve.staging``.

``DoubleBuffer`` owns two pre-allocated ``[T, nodes, width]`` host
buffer sets (numpy) in the exact tick-major layout ``CompiledPipeline.
run_epoch`` consumes. The executor stages epoch ``k+1``'s arrivals into
the active set while epoch ``k`` — already handed to ``run_epoch`` —
runs on the device. ``run_epoch`` copies the set to the device at
dispatch, from pageable memory, so the copy has ended when it returns
and the set may be zeroed at the next ``swap()``: no copy is ever in
flight from a buffer the host writes. ``swap()`` hands the filled set
over and re-activates the other (zeroed) one.

Per-(tick, node) packing reuses ``data.stream._pack_prefix`` — the ONE
epoch-ingest backpressure rule in the repo — so items beyond ``width``
are prefix-truncated exactly like every other ingest path; truncations
are counted (``truncated_total``) and the executor folds them into the
same α accounting as queue drops.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.data.stream import _pack_prefix


class StagedEpoch(NamedTuple):
    """One swapped-out epoch of staged ingest.

    ``values``/``strata``/``counts`` are ready for ``run_epoch``;
    ``offered`` is the pre-truncation per-(tick, node) count and
    ``first_arrival`` the earliest item-arrival timestamp staged into
    each tick row (``inf`` for empty ticks) — the window-latency clock
    starts there.
    """

    values: np.ndarray        # f32[T, nodes, width]
    strata: np.ndarray        # i32[T, nodes, width]
    counts: np.ndarray        # i32[T, nodes]
    offered: np.ndarray       # i64[T, nodes]
    first_arrival: np.ndarray  # f64[T]


class DoubleBuffer:
    def __init__(self, epoch_ticks: int, n_nodes: int, width: int):
        if epoch_ticks < 1 or n_nodes < 1 or width < 1:
            raise ValueError("epoch_ticks, n_nodes, width must be >= 1")
        self.epoch_ticks = int(epoch_ticks)
        self.n_nodes = int(n_nodes)
        self.width = int(width)
        self._bufs = [self._alloc(), self._alloc()]
        self._active = 0
        self.staged_total = 0
        self.truncated_total = 0
        self.swaps = 0

    def _alloc(self) -> dict:
        t, n, w = self.epoch_ticks, self.n_nodes, self.width
        return {
            "values": np.zeros((t, n, w), np.float32),
            "strata": np.zeros((t, n, w), np.int32),
            "counts": np.zeros((t, n), np.int32),
            "offered": np.zeros((t, n), np.int64),
            "first_arrival": np.full((t,), np.inf, np.float64),
        }

    # ----------------------------------------------------------- stage --
    def stage(self, t: int, node: int, values, strata,
              arrival: float | None = None) -> int:
        """Pack one shard's drained items into active tick-row ``t``;
        returns how many fit (the rest are truncated and counted)."""
        buf = self._bufs[self._active]
        values = np.asarray(values, np.float32)
        strata = np.asarray(strata, np.int32)
        fill = int(buf["counts"][t, node])
        new_fill = _pack_prefix(buf["values"][t, node], buf["strata"][t, node],
                                values, strata, fill, self.width)
        staged = new_fill - fill
        buf["counts"][t, node] = new_fill
        buf["offered"][t, node] += values.size
        self.staged_total += staged
        self.truncated_total += values.size - staged
        if arrival is not None and staged:
            buf["first_arrival"][t] = min(buf["first_arrival"][t],
                                          float(arrival))
        return staged

    def first_arrival(self, t: int) -> float:
        """Earliest arrival staged into active tick-row ``t`` so far."""
        return float(self._bufs[self._active]["first_arrival"][t])

    # ------------------------------------------------------------ swap --
    def swap(self) -> StagedEpoch:
        """Hand the active (filled) set over and activate the other one,
        zeroed for reuse. The returned arrays stay valid until the swap
        after next — ``run_epoch`` copies them host→device at dispatch,
        so that lifetime is enough by construction."""
        buf = self._bufs[self._active]
        out = StagedEpoch(buf["values"], buf["strata"], buf["counts"],
                          buf["offered"], buf["first_arrival"])
        self._active ^= 1
        nxt = self._bufs[self._active]
        nxt["values"][:] = 0.0
        nxt["strata"][:] = 0
        nxt["counts"][:] = 0
        nxt["offered"][:] = 0
        nxt["first_arrival"][:] = np.inf
        self.swaps += 1
        return out
