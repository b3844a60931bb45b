"""Error estimation for approximate linear queries (§III-D).

The counterpart of ``repro.core.error``. Each stratum contributes
``Y_i`` uniformly sampled items with weight ``W_i^out``; by the CLT with
finite-population correction

    Var(SUM_i)  = c_src_i · (c_src_i − Y_i) · s_i² / Y_i          (Eq. 11)
    Var(MEAN_*) = Σ_i φ_i² · s_i²/Y_i · (c_src_i − Y_i)/c_src_i    (Eq. 14)

with ``c_src_i = Y_i · W_i^out`` and ``φ_i = c_src_i / Σ c_src``. Sums
over strata run left to right with the reference's FMA contractions,
so the answers equal the reference's bit for bit. The per-stratum
moments are segment sums in item order, on the card through the
``segment_sum`` kernel, so the card's answers equal the CPU's too.
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import (fma, fma_dot, segment_count,
                                      segment_sum, seq_sum)
from repro_torch.core.types import QueryResult, StratumMeta


def stratum_moments(value, stratum, selected, num_strata: int):
    """Per-stratum (Y_i, Σx, Σx²) over the sampled items. f32[X] each."""
    seg = torch.where(selected, stratum, num_strata)
    y = segment_count(seg, num_strata)
    s1 = segment_sum(torch.where(selected, value, 0.0), seg, num_strata)
    s2 = segment_sum(torch.where(selected, value * value, 0.0), seg,
                     num_strata)
    return y, s1, s2


def sample_variance(y, s1, s2):
    """Unbiased per-stratum sample variance ``s_i²`` (Eq. 12); 0 when
    ``Y_i < 2``."""
    mean = s1 / torch.clamp_min(y, 1.0)
    # s2 − (y·mean)·mean, contracted to one FMA as in the reference.
    ss = torch.clamp_min(fma(-(y * mean), mean, s2), 0.0)
    return torch.where(y > 1.0, ss / torch.clamp_min(y - 1.0, 1.0), 0.0)


def approx_sum(value, stratum, selected, meta: StratumMeta,
               num_strata: int) -> QueryResult:
    """``SUM_* ± bound`` (Eq. 3 + Eq. 11)."""
    y, s1, s2 = stratum_moments(value, stratum, selected, num_strata)
    return approx_sum_from_moments(y, s1, s2, meta)


def approx_sum_from_moments(y, s1, s2, meta: StratumMeta) -> QueryResult:
    s_sq = sample_variance(y, s1, s2)
    c_src = y * meta.weight
    fpc = torch.clamp_min(c_src - y, 0.0)
    var_per = torch.where(y > 0.0, c_src * fpc * s_sq
                          / torch.clamp_min(y, 1.0), 0.0)
    return QueryResult(estimate=fma_dot(s1, meta.weight),
                       variance=seq_sum(var_per)[..., 0])


def approx_mean(value, stratum, selected, meta: StratumMeta,
                num_strata: int) -> QueryResult:
    """``MEAN_* ± bound`` (Eq. 13 + Eq. 14)."""
    y, s1, s2 = stratum_moments(value, stratum, selected, num_strata)
    return approx_mean_from_moments(y, s1, s2, meta)


def approx_mean_from_moments(y, s1, s2, meta: StratumMeta,
                             ht_total=None) -> QueryResult:
    """``ht_total`` is ``Σ_i Y_i·W_i`` when the caller has it; by default
    it is taken with one FMA per stratum, as the reference's compiled
    code takes it where no other query shares the product."""
    s_sq = sample_variance(y, s1, s2)
    c_src = y * meta.weight
    if ht_total is None:
        ht_total = fma_dot(y, meta.weight)
    total = torch.clamp_min(ht_total, 1.0)[..., None]
    phi = c_src / total
    mean_per = s1 / torch.clamp_min(y, 1.0)
    est = fma_dot(phi, mean_per)
    var_per = torch.where((y > 0.0) & (c_src > 0.0),
                          phi * phi * s_sq / torch.clamp_min(y, 1.0)
                          * fpc_ratio(c_src, y), 0.0)
    return QueryResult(estimate=est, variance=seq_sum(var_per)[..., 0])


def fpc_ratio(c_src, y):
    """Finite-population correction ``(c_src − Y)/c_src``."""
    return torch.clamp_min(c_src - y, 0.0) / torch.clamp_min(c_src, 1.0)
