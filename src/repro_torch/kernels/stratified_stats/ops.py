"""``stratified_stats``: per-stratum (count, Σx, Σx²) over masked items.

On a CUDA tensor the wrapper launches ``csrc/stratified_stats.cu``; on
a CPU tensor it calls the plain version in ``ref.py``. Any other case
raises: there is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.stratified_stats import ref

# Any X up to this: the kernel keeps a row of shared memory per thread
# (up to 24 strata) or per warp (above) and stratum, and takes fewer
# threads where X rows do not fit (128 at 4,096 strata).
MAX_STRATA = 4096


def _lib():
    lib = _build.load("stratified_stats")
    fn = lib.stratified_stats_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, P, P]
        fn.restype = I
    return lib


def stratified_stats(values: torch.Tensor, strata: torch.Tensor,
                     mask: torch.Tensor, num_strata: int) -> torch.Tensor:
    """f32[X, 3] per-stratum (count, Σx, Σx²) over ``mask``ed items.
    Counts are exact; on the card Σx and Σx² are summed in a fixed order
    that depends only on (M, X) (deterministic from run to run, not the
    CPU's item order), in one launch."""
    if values.device.type == "cpu":
        return ref.stratified_stats(values, strata, mask, num_strata)
    if values.device.type != "cuda":
        raise ValueError(f"stratified_stats: unsupported device "
                         f"{values.device}")
    m = values.shape[0]
    if values.dim() != 1 or strata.shape != (m,) or mask.shape != (m,):
        raise ValueError("stratified_stats: values, strata and mask must "
                         "be 1-D of one length")
    if (values.dtype, strata.dtype, mask.dtype) != (
            torch.float32, torch.int32, torch.bool):
        raise TypeError("stratified_stats: needs f32 values, i32 strata, "
                        "bool mask")
    if not 1 <= num_strata <= MAX_STRATA:
        raise ValueError(f"stratified_stats: num_strata must be in "
                         f"[1, {MAX_STRATA}], got {num_strata}")
    for t in (strata, mask):
        if t.device != values.device:
            raise ValueError("stratified_stats: inputs on different devices")
    values, strata, mask = (t.contiguous() for t in (values, strata, mask))
    # The kernel writes every element; it needs no scratch.
    out = torch.empty((num_strata, 3), dtype=torch.float32,
                      device=values.device)
    lib = _lib()
    P = _build.ptr
    rc = lib.stratified_stats_launch(
        P(values), P(strata), P(mask), m, num_strata, P(out),
        _build.stream_of(values))
    _build.check(lib, rc, "stratified_stats")
    LAUNCHES["stratified_stats"] += 1
    return out
