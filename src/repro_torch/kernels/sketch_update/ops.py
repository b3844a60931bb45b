"""The sketch-update passes: kernel or plain version.

On a CUDA tensor each wrapper launches its kernel from
``csrc/sketch_update.cu``; on a CPU tensor it calls the plain version in
``ref.py``. Any other case raises: there is no fallback from the card to
the plain version. Both give the same bits: ``cms_update`` adds each
bucket's weights in item order, ``quantile_compact`` applies the same
membership rule.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.sketch_update import ref


def _lib():
    lib = _build.load("sketch_update")
    if lib.cms_update_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cms_update_launch.argtypes = [P, P, I, I, I, I, P, P]
        lib.cms_update_launch.restype = I
        lib.quantile_compact_launch.argtypes = [P, P, P, P, I, I, P, P]
        lib.quantile_compact_launch.restype = I
    return lib


def _check(what: str, device, dtypes: dict, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{device}")
        if t.dim() != 1:
            raise ValueError(f"{what}: {name} must be 1-D, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{what}: {name} must be {dtypes[name]}, got "
                            f"{t.dtype}")


def _route(what: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def cms_update(keys: torch.Tensor, weights: torch.Tensor, depth: int,
               width: int) -> torch.Tensor:
    """f32[depth, width] weighted count-min increments of ``keys`` (i32,
    hashed as uint32) with ``weights`` (f32; 0 leaves a bucket as it is).
    ``width`` must be a power of two and ``depth`` at most 6."""
    ref.check_shape(depth, width)
    if not _route("cms_update", keys):
        return ref.cms_update(keys, weights, depth, width)
    _check("cms_update", keys.device,
           {"keys": torch.int32, "weights": torch.float32},
           keys=keys, weights=weights)
    m = keys.shape[0]
    if weights.shape[0] != m:
        raise ValueError("cms_update: keys and weights differ in length")
    keys, weights = keys.contiguous(), weights.contiguous()
    out = torch.empty((depth, width), dtype=torch.float32,
                      device=keys.device)
    lib = _lib()
    P = _build.ptr
    rc = lib.cms_update_launch(P(keys), P(weights), m, depth, width,
                               ref.hash_shift(width), P(out),
                               _build.stream_of(keys))
    _build.check(lib, rc, "cms_update")
    LAUNCHES["cms_update"] += 1
    return out


def quantile_compact(values: torch.Tensor, cumw_prev: torch.Tensor,
                     cumw: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
    """f32[C]: the value of the slot whose ``[cumw_prev, cumw)`` interval
    holds each target (``values``, ``cumw_prev``, ``cumw`` f32[P],
    ``targets`` f32[C]); 0 for a target that no interval holds."""
    if not _route("quantile_compact", values):
        return ref.quantile_compact(values, cumw_prev, cumw, targets)
    f32 = torch.float32
    _check("quantile_compact", values.device,
           {"values": f32, "cumw_prev": f32, "cumw": f32, "targets": f32},
           values=values, cumw_prev=cumw_prev, cumw=cumw, targets=targets)
    p, c = values.shape[0], targets.shape[0]
    if cumw_prev.shape[0] != p or cumw.shape[0] != p:
        raise ValueError("quantile_compact: values, cumw_prev and cumw "
                         "differ in length")
    out = torch.empty((c,), dtype=f32, device=values.device)
    if c == 0:
        return out
    values, cumw_prev, cumw, targets = (
        t.contiguous() for t in (values, cumw_prev, cumw, targets))
    lib = _lib()
    P = _build.ptr
    rc = lib.quantile_compact_launch(P(values), P(cumw_prev), P(cumw),
                                     P(targets), p, c, P(out),
                                     _build.stream_of(values))
    _build.check(lib, rc, "quantile_compact")
    LAUNCHES["quantile_compact"] += 1
    return out
