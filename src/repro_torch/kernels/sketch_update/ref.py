"""Plain PyTorch versions of the sketch-update kernels.

Mirrors ``repro/kernels/sketch_update/ref.py``:

* ``hash_buckets`` — the multiply-shift hash ``(A[d]·key mod 2³²) >>
  (32 − log₂ width)`` per depth row, computed in int64 and masked to 32
  bits, so it is the same on every device.
* ``cms_update`` — the weighted count-min delta as one ``index_add_``
  over the flattened ``[depth·M]`` buckets. On the CPU that adds each
  bucket's weights in item order, as the reference's scatter does, so
  the two agree bit for bit.
* ``quantile_compact`` — the interval-membership sum: for each target
  ``t``, the values of the slots with ``cumw_prev ≤ t < cumw``. The
  sketch's intervals come from a blocked cumsum that can fall by an ulp
  at a block boundary, so a target may lie in two slots; two values sum
  alike in any order. Three or more would be added in ``torch.sum``'s
  own association.
"""
from __future__ import annotations

import torch

# Odd multiply-shift constants (the reference's HASH_MULTIPLIERS):
# h_d(x) = (A[d]·x mod 2³²) >> (32 − log₂ width).
HASH_MULTIPLIERS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
                    0x165667B1, 0xD3A2646D)
_MASK = 0xFFFFFFFF


def check_shape(depth: int, width: int) -> None:
    """Raise unless ``width`` is a power of two and ``1 ≤ depth ≤ 6``."""
    if width < 1 or width & (width - 1):
        raise ValueError(f"count-min width must be a power of 2, got {width}")
    if not 1 <= depth <= len(HASH_MULTIPLIERS):
        raise ValueError(f"count-min depth must be in [1, "
                         f"{len(HASH_MULTIPLIERS)}], got {depth}")


def hash_shift(width: int) -> int:
    return 32 - (width - 1).bit_length()


def hash_buckets(keys: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """i64[depth, M] buckets of integer ``keys`` (taken as uint32)."""
    check_shape(depth, width)
    mult = torch.tensor(HASH_MULTIPLIERS[:depth], dtype=torch.int64,
                        device=keys.device)
    k = keys.to(torch.int64) & _MASK
    prod = (k[None, :] * mult[:, None]) & _MASK
    shift = hash_shift(width)
    return prod >> shift if shift < 32 else torch.zeros_like(prod)


def cms_update(keys: torch.Tensor, weights: torch.Tensor, depth: int,
               width: int) -> torch.Tensor:
    """f32[depth, width] weighted bucket increments (scatter-add form)."""
    buckets = hash_buckets(keys, depth, width)
    rows = torch.arange(depth, dtype=torch.int64, device=keys.device)
    flat = (rows[:, None] * width + buckets).reshape(-1)
    out = torch.zeros(depth * width, dtype=torch.float32, device=keys.device)
    out.index_add_(0, flat, weights.float().expand(depth, -1).reshape(-1))
    return out.reshape(depth, width)


def quantile_compact(values: torch.Tensor, cumw_prev: torch.Tensor,
                     cumw: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
    """f32[C]: a target in ``[cumw_prev_i, cumw_i)`` picks slot ``i``; a
    target at or past the total weight picks nothing and gives 0."""
    hit = ((cumw_prev[:, None] <= targets[None, :])
           & (targets[None, :] < cumw[:, None]))
    return torch.where(hit, values[:, None], 0.0).sum(dim=0)
