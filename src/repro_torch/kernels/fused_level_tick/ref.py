"""Plain PyTorch version of the fused level-tick kernels.

Mirrors ``repro/kernels/fused_level_tick/ref.py``: it composes the
unfused stages — per-stratum counts, reservoir allocation, the
stable-lexsort selection law, the Alg. 2 weight update and the row-wise
compaction — so the kernels are held against them stage by stage.
"""
from __future__ import annotations

import torch

from repro_torch.core import sampling, whs


def fused_level_tick(values, strata, valid, priorities, w_in, c_in,
                     sample_size, num_strata: int, out_capacity: int, *,
                     allocation: str = "fair",
                     async_calibration: bool = True):
    """``[n, cap]`` level buffers → ``(keep, values_c, strata_c, n_keep,
    c, reservoirs, y, w_out, c_out)``."""
    c = sampling.stratum_counts(strata, valid, num_strata)
    stds = None
    if allocation == "neyman":
        stds = sampling.stratum_stds(values, strata, valid, num_strata)
    res = sampling.allocate_reservoirs(sample_size, c, policy=allocation,
                                       stds=stds)
    keep = sampling.stratified_priority_sample(
        None, strata, valid, res, num_strata, priorities=priorities)
    y, meta = whs._whs_meta(c, res, w_in, c_in, async_calibration)
    values_c, strata_c, n_keep = whs.pack_rows(values, strata, keep,
                                               out_capacity)
    return (keep, values_c, strata_c, n_keep, c, res, y, meta.weight,
            meta.count)


def fused_select(priorities: torch.Tensor, strata: torch.Tensor,
                 valid: torch.Tensor, reservoirs: torch.Tensor,
                 num_strata: int) -> torch.Tensor:
    """Selection only, with caller-given reservoirs. bool[M]."""
    return sampling.stratified_priority_sample(
        None, strata, valid, reservoirs, num_strata, priorities=priorities)
