"""Plain PyTorch version of the ``stratified_stats`` kernel.

Mirrors ``repro/kernels/stratified_stats/ref.py``: per stratum over the
masked items, ``(count, Σx, Σx²)`` as f32[X, 3], by scatter-adds in
item order.
"""
from __future__ import annotations

import torch


def stratified_stats(values: torch.Tensor, strata: torch.Tensor,
                     mask: torch.Tensor, num_strata: int) -> torch.Tensor:
    # Items of strata outside [0, X) are dropped, as the reference's
    # scatter drops out-of-range ids.
    ok = mask & (strata >= 0) & (strata < num_strata)
    seg = torch.where(ok, strata, num_strata).to(torch.int64)
    x = torch.where(mask, values, 0.0)
    out = torch.zeros((3, num_strata + 1), dtype=torch.float32,
                      device=values.device)
    out[0].index_add_(0, seg, torch.ones_like(values))
    out[1].index_add_(0, seg, x)
    out[2].index_add_(0, seg, torch.where(mask, values * values, 0.0))
    return out[:, :num_strata].T.contiguous()
