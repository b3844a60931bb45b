"""The fused level tick and fused selection: kernel or plain version.

On a CUDA tensor each wrapper launches its kernel from
``csrc/fused_level_tick.cu``; on a CPU tensor it calls the plain version
in ``ref.py``. Any other case raises: there is no fallback from the card
to the plain version. Both give the same bits (the kernels' tie law is
the stable lexsort's, their f32 arithmetic is the plain version's).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.fused_level_tick import ref

MAX_STRATA = 32
_POLICIES = {"fair": 0, "proportional": 1, "neyman": 2}


def _lib():
    lib = _build.load("fused_level_tick")
    if lib.fused_level_tick_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_level_tick_launch.argtypes = (
            [P] * 7 + [I] * 6 + [P] * 9 + [P])
        lib.fused_level_tick_launch.restype = I
        lib.fused_select_launch.argtypes = [P, P, P, P, I, I, P, P]
        lib.fused_select_launch.restype = I
    return lib


def _need(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_items(what, shape, device, **tensors):
    dtypes = {"values": torch.float32, "priorities": torch.float32,
              "strata": torch.int32, "valid": torch.bool}
    for name, t in tensors.items():
        _need(t.device == device, what, f"{name} is on {t.device}, "
              f"expected {device}")
        _need(tuple(t.shape) == tuple(shape), what,
              f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{what}: {name} must be {dtypes[name]}, "
                            f"got {t.dtype}")
        _need(t.is_contiguous(), what, f"{name} must be contiguous")


def _as_device_f32(x, device, what, name) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    _need(t.device == device, what, f"{name} is on {t.device}")
    return t.contiguous()


def fused_level_tick(values, strata, valid, priorities, w_in, c_in,
                     sample_size, num_strata: int, out_capacity: int, *,
                     allocation: str = "fair",
                     async_calibration: bool = True):
    """One fused WHS tick over a stacked level ``[n, cap]``. Returns
    ``(keep, values_c, strata_c, n_keep, c, reservoirs, y, w_out,
    c_out)``; ``n_keep`` is the kept count (not clipped to
    ``out_capacity``)."""
    if values.device.type == "cpu":
        return ref.fused_level_tick(
            values, strata, valid, priorities, w_in, c_in, sample_size,
            num_strata, out_capacity, allocation=allocation,
            async_calibration=async_calibration)
    what = "fused_level_tick"
    _need(values.device.type == "cuda", what,
          f"unsupported device {values.device}")
    dev = values.device
    _need(values.dim() == 2 and values.shape[0] >= 1 and values.shape[1] >= 1,
          what, "values must be [n, cap] with n, cap >= 1")
    n, cap = values.shape
    _check_items(what, (n, cap), dev, values=values, strata=strata,
                 valid=valid, priorities=priorities)
    _need(1 <= num_strata <= MAX_STRATA, what,
          f"num_strata must be in [1, {MAX_STRATA}], got {num_strata}")
    _need(1 <= out_capacity <= cap, what,
          f"out_capacity must be in [1, cap={cap}], got {out_capacity}")
    _need(allocation in _POLICIES, what,
          f"unknown allocation policy {allocation!r}")
    w_in = _as_device_f32(w_in, dev, what, "w_in")
    c_in = _as_device_f32(c_in, dev, what, "c_in")
    for name, t in (("w_in", w_in), ("c_in", c_in)):
        _need(tuple(t.shape) == (n, num_strata), what,
              f"{name} must be [{n}, {num_strata}], got {tuple(t.shape)}")
    size = _as_device_f32(sample_size, dev, what, "sample_size")
    _need(size.numel() == 1, what, "sample_size must be one number")

    f32 = dict(dtype=torch.float32, device=dev)
    keep = torch.empty((n, cap), dtype=torch.bool, device=dev)
    values_c = torch.empty((n, out_capacity), **f32)
    strata_c = torch.empty((n, out_capacity), dtype=torch.int32, device=dev)
    n_keep = torch.empty((n,), dtype=torch.int32, device=dev)
    c, res, y, w_out, c_out = (torch.empty((n, num_strata), **f32)
                               for _ in range(5))
    lib = _lib()
    P = _build.ptr
    rc = lib.fused_level_tick_launch(
        P(values), P(strata), P(valid), P(priorities), P(w_in), P(c_in),
        P(size), n, cap, num_strata, out_capacity, _POLICIES[allocation],
        int(bool(async_calibration)), P(keep), P(values_c), P(strata_c),
        P(n_keep), P(c), P(res), P(y), P(w_out), P(c_out),
        _build.stream_of(values))
    _build.check(lib, rc, what)
    LAUNCHES["fused_level_tick"] += 1
    return keep, values_c, strata_c, n_keep, c, res, y, w_out, c_out


def fused_select(priorities, strata, valid, reservoirs,
                 num_strata: int) -> torch.Tensor:
    """Selection only (the ``SamplerBackend.select`` contract): the τ
    search and tie law over caller-given reservoirs, keep-all when every
    reservoir covers its count. bool[M]."""
    if priorities.device.type == "cpu":
        return ref.fused_select(priorities, strata, valid, reservoirs,
                                num_strata)
    what = "fused_select"
    _need(priorities.device.type == "cuda", what,
          f"unsupported device {priorities.device}")
    dev = priorities.device
    _need(priorities.dim() == 1 and priorities.shape[0] >= 1, what,
          "priorities must be [M] with M >= 1")
    m = priorities.shape[0]
    _check_items(what, (m,), dev, priorities=priorities, strata=strata,
                 valid=valid)
    _need(1 <= num_strata <= MAX_STRATA, what,
          f"num_strata must be in [1, {MAX_STRATA}], got {num_strata}")
    res = _as_device_f32(reservoirs, dev, what, "reservoirs")
    _need(tuple(res.shape) == (num_strata,), what,
          f"reservoirs must be [{num_strata}], got {tuple(res.shape)}")
    keep = torch.empty((m,), dtype=torch.bool, device=dev)
    lib = _lib()
    P = _build.ptr
    rc = lib.fused_select_launch(P(priorities), P(strata), P(valid), P(res),
                                 m, num_strata, P(keep),
                                 _build.stream_of(priorities))
    _build.check(lib, rc, what)
    LAUNCHES["fused_select"] += 1
    return keep
