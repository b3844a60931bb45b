"""``segment_sum``: per-segment sums along the last axis.

On a CPU tensor, and for integer values on any device, the plain version
(``index_add_``: item order on the CPU; integer atomics on the card,
which are exact in any order). For float32 values on a CUDA tensor the
wrapper launches ``csrc/segment_sum.cu``, which adds each segment's
items in item order, so the card's float sums equal the CPU's bit for
bit. Any other case raises: there is no fallback from the card to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.segment_sum import ref


def _lib():
    lib = _build.load("segment_sum")
    for fn in (lib.segment_sum_launch, lib.segment_sum_launch_i64):
        if fn.argtypes is None:
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [P, P, I, I, I, P, P]
            fn.restype = I
    return lib


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``[..., M]`` values and ids → ``[..., S]`` sums; ids outside
    ``[0, S)`` are dropped."""
    _build.plain_only("segment_sum", values, seg)
    if values.device.type == "cpu" or not values.is_floating_point():
        return ref.segment_sum(values, seg, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {values.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"segment_sum: float values must be float32 on the "
                        f"card, got {values.dtype}")
    if seg.shape != values.shape or seg.device != values.device:
        raise ValueError("segment_sum: values and ids must have one shape "
                         "and one device")
    lead = values.shape[:-1]
    m = values.shape[-1]
    rows = values.numel() // m if m else 0
    if rows == 0 or num_segments == 0:
        return torch.zeros(lead + (num_segments,), dtype=torch.float32,
                           device=values.device)
    # The kernel writes every element: no fill before it.
    out = torch.empty(lead + (num_segments,), dtype=torch.float32,
                      device=values.device)
    # int32 and int64 ids go in as they are (the kernel skips ids outside
    # [0, S)); narrower integer ids widen to int32 without loss.
    if seg.dtype not in (torch.int32, torch.int64):
        seg = seg.to(torch.int32)
    ids = seg.contiguous()
    values = values.contiguous()
    lib = _lib()
    launch = (lib.segment_sum_launch_i64 if ids.dtype == torch.int64
              else lib.segment_sum_launch)
    rc = launch(_build.ptr(values), _build.ptr(ids), rows, m, num_segments,
                _build.ptr(out), _build.stream_of(values))
    _build.check(lib, rc, "segment_sum")
    LAUNCHES["segment_sum"] += 1
    return out
