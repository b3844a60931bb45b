"""The whole hierarchy's interval state (§III-A "foreach time interval").

The counterpart of ``repro.core.window.TreeState``, the state the scan
engine carries from tick to tick. Within one interval a node may receive
several messages carrying ``(W^out, C^out)`` sets: the counts sum and the
weights combine as the count-weighted mean ``Σ w_k C_k / Σ C_k``. Across
intervals the sets are sticky: items that arrive before their metadata
use the most recent ``W^in``/``C^in``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
