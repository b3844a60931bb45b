"""Plain PyTorch version of the ``sample_mask`` kernel.

Mirrors ``repro/kernels/sample_mask/ref.py``: per item

    keep_k = valid_k ∧ (u_k ≥ τ[s_k])
    w_k    = keep_k ? W[s_k] : 0

with the reference's indexing of ``τ[s]``: a negative index counts
from the end (``s + X``), then the index is clamped into ``[0, X)``.
The pipeline only gives valid items strata in ``[0, X)``; the wrapping
and clamping matter for padding slots, whose strata are arbitrary.
"""
from __future__ import annotations

import torch


def sample_mask(priorities: torch.Tensor, strata: torch.Tensor,
                valid: torch.Tensor, tau: torch.Tensor,
                weights: torch.Tensor):
    """→ ``(keep bool[M], w f32[M])``."""
    x = tau.shape[0]
    s = strata.to(torch.int64)
    ix = torch.where(s < 0, s + x, s).clamp(0, x - 1)
    keep = valid & (priorities >= tau[ix])
    return keep, torch.where(keep, weights[ix], 0.0)
