"""Simple Random Sampling baseline (§IV-B "coin flip sampling").

The counterpart of ``repro.core.srs``: every item is kept independently
with probability ``fraction``; a linear query's estimate scales the
sample aggregate by ``1/fraction``.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.types import IntervalBatch, QueryResult


def srs_select(key, batch: IntervalBatch, fraction,
               priorities: torch.Tensor | None = None) -> torch.Tensor:
    """Bernoulli(fraction) per valid item → bool[M]; ``priorities`` are
    the uniforms of ``key`` when the caller drew them already."""
    u = prng.uniform(key, (batch.capacity,)) if priorities is None \
        else priorities
    return (u < fraction) & batch.valid


def level_srs_select(keys, valid, fraction,
                     priorities: torch.Tensor | None = None) -> torch.Tensor:
    """``srs_select`` over a stacked level: one key per node, ``valid``
    ``[n, cap]``; the same per-node uniforms ``srs_select`` draws."""
    u = prng.uniform(keys, (valid.shape[1],)) if priorities is None \
        else priorities
    return (u < fraction) & valid


def srs_sum(batch: IntervalBatch, selected, fraction) -> QueryResult:
    """Horvitz–Thompson SUM, variance ``Σ x²·(1−p)/p²`` over the sample."""
    x = torch.where(selected, batch.value, 0.0)
    p = torch.as_tensor(fraction, dtype=torch.float32, device=x.device)
    return QueryResult(estimate=x.sum() / p,
                       variance=(x * x).sum() * (1.0 - p) / (p * p))


def srs_mean(batch: IntervalBatch, selected, fraction) -> QueryResult:
    """Plain sample mean (SRS is self-weighting)."""
    n = torch.clamp_min(selected.float().sum(), 1.0)
    x = torch.where(selected, batch.value, 0.0)
    mean = x.sum() / n
    ss = torch.where(selected, (batch.value - mean) ** 2, 0.0).sum()
    s_sq = ss / torch.clamp_min(n - 1.0, 1.0)
    return QueryResult(estimate=mean, variance=s_sq / n)
