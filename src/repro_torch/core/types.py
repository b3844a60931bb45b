"""Core data model: interval batches, per-stratum metadata, results.

The counterpart of ``repro.core.types``: the unit of work is a
fixed-capacity buffer of items one node observed in one interval, each
tagged with its stratum, plus the per-stratum weight set ``W`` and count
set ``C`` received from downstream (Alg. 1 of the paper). Fixed
capacity keeps every shape static; ``valid`` carries the item count.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class StratumMeta(NamedTuple):
    """Per-stratum ``W`` (effective inverse sampling probability, Eq. 1
    / Eq. 9) and ``C`` (items the downstream node forwarded). f32[X]."""

    weight: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def identity(num_strata: int, device=None) -> "StratumMeta":
        """Source-level metadata: weight 1, count 0 (no downstream node)."""
        return StratumMeta(
            weight=torch.ones((num_strata,), dtype=torch.float32,
                              device=device),
            count=torch.zeros((num_strata,), dtype=torch.float32,
                              device=device))


class IntervalBatch(NamedTuple):
    """All items a node observes for one interval: ``value`` f32[M],
    ``stratum`` i32[M], ``valid`` bool[M] and the latest ``meta``."""

    value: torch.Tensor
    stratum: torch.Tensor
    valid: torch.Tensor
    meta: StratumMeta

    @property
    def capacity(self) -> int:
        return self.value.shape[-1]


class SampleResult(NamedTuple):
    """Output of one WHSamp call (Alg. 2): the keep mask, the outgoing
    ``W^out``/``C^out``, and per-stratum ``c`` (observed), ``y``
    (selected, ``min(c, N)``) and ``reservoir`` (``N``). f32[X] each."""

    selected: torch.Tensor
    meta: StratumMeta
    c: torch.Tensor
    y: torch.Tensor
    reservoir: torch.Tensor


class QueryResult(NamedTuple):
    """Approximate query output with its CLT variance (§III-D)."""

    estimate: torch.Tensor
    variance: torch.Tensor
