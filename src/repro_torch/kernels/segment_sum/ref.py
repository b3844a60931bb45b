"""Plain PyTorch version of the ordered ``segment_sum`` kernel.

``Σ values`` per segment along the last axis, as one ``index_add_`` over
the flattened rows. On the CPU ``index_add_`` adds in item order, which
is the order of the reference's ``.at[seg].add`` scatter; ids outside
``[0, S)`` land in a spare slot that is cut off (the scatter drops them).
"""
from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``[..., M]`` values and ids → ``[..., S]`` sums."""
    lead = values.shape[:-1]
    rows = 1
    for d in lead:
        rows *= d
    v = values.reshape(rows, -1)
    s = seg.reshape(rows, -1).to(torch.int64)
    width = num_segments + 1
    ok = (s >= 0) & (s < num_segments)
    idx = torch.where(ok, s, num_segments)
    idx = idx + torch.arange(rows, device=v.device)[:, None] * width
    out = torch.zeros(rows * width, dtype=v.dtype, device=v.device)
    out.index_add_(0, idx.reshape(-1), v.reshape(-1))
    return out.reshape(lead + (width,))[..., :num_segments]
