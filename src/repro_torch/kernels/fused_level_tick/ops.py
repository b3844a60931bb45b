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
from repro_torch.obs.trace import span

# Per-stratum cluster state sits in each CTA's dynamic shared memory: five
# words a stratum and two radix-digit histograms of 2^b words a stratum,
# within _SMEM_WORDS (208 KB; b = 2 at 4,096 strata); with neyman the
# launch adds the moments phase's tiles (stds_plan, up to 227 KB in all).
# The tie lists and, above 4 strata, the allocation's arrays live in global
# scratch.
MAX_STRATA = 4096
_POLICIES = {"fair": 0, "proportional": 1, "neyman": 2}
_STATE_ARRAYS, _SMEM_WORDS = 5, 53248
# CTAs per node: one thread-block cluster of the portable size. Fewer were
# slower at every shape of the main path (tools/fused_tick_phases.py).
CLUSTER = 8


def digit_bits(num_strata: int) -> int:
    """Bits per radix digit of the kernels' τ search at ``num_strata``
    strata (``digit_bits`` in ``csrc/fused_level_tick.cu``): 8 while two
    histogram buffers fit beside the per-stratum arrays, fewer above."""
    b = 8
    while b > 2 and (_STATE_ARRAYS + 2 * (1 << b)) * num_strata > _SMEM_WORDS:
        b -= 1
    return b


def _lib():
    lib = _build.load("fused_level_tick")
    if lib.fused_level_tick_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_level_tick_launch.argtypes = (
            [P] * 7 + [I] * 7 + [P] * 11 + [P])
        lib.fused_level_tick_launch.restype = I
        lib.fused_select_launch.argtypes = [P, P, P, P, I, I, I, P, P, P]
        lib.fused_select_launch.restype = I
        for fn in (lib.fused_level_tick_scratch_words,
                   lib.fused_level_tick_digit_bits,
                   lib.fused_level_tick_radix_passes):
            fn.argtypes = [I]
            fn.restype = I
        lib.fused_level_tick_moment_windows.argtypes = [I, I]
        lib.fused_level_tick_moment_windows.restype = I
    return lib


def regime(num_strata: int, allocation: str) -> dict:
    """The kernel's strata regime at ``num_strata`` strata, from the
    functions ``csrc/fused_level_tick.cu`` exports: bits per radix digit,
    passes of the τ search over a node's slots, and walks of the neyman
    moments over its valid prefix (0 for the other policies)."""
    lib = _lib()
    return {"digit_bits": lib.fused_level_tick_digit_bits(num_strata),
            "radix_passes": lib.fused_level_tick_radix_passes(num_strata),
            "moment_windows": lib.fused_level_tick_moment_windows(
                num_strata, _POLICIES[allocation])}


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
    ``out_capacity``).

    Each call is the span ``level_tick`` (meta ``nodes``, ``slots``,
    ``strata``; on the card also the launch's :func:`regime`)."""
    with span("level_tick") as meta:
        out = _level_tick(values, strata, valid, priorities, w_in, c_in,
                          sample_size, num_strata, out_capacity, allocation,
                          async_calibration)
        if meta is not None:
            meta.update(nodes=values.shape[0], slots=values.shape[-1],
                        strata=num_strata)
            if values.device.type == "cuda":
                meta.update(regime(num_strata, allocation))
        return out


def _level_tick(values, strata, valid, priorities, w_in, c_in, sample_size,
                num_strata, out_capacity, allocation, async_calibration):
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
    scratch = torch.empty(
        (n * lib.fused_level_tick_scratch_words(num_strata),), **f32)
    ties = torch.empty((n * cap,), dtype=torch.int32, device=dev)
    P = _build.ptr
    rc = lib.fused_level_tick_launch(
        P(values), P(strata), P(valid), P(priorities), P(w_in), P(c_in),
        P(size), n, cap, num_strata, out_capacity, _POLICIES[allocation],
        int(bool(async_calibration)), CLUSTER, P(scratch),
        P(ties), P(keep),
        P(values_c), P(strata_c), P(n_keep), P(c), P(res), P(y), P(w_out),
        P(c_out), _build.stream_of(values))
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
    ties = torch.empty((m,), dtype=torch.int32, device=dev)
    lib = _lib()
    P = _build.ptr
    rc = lib.fused_select_launch(P(priorities), P(strata), P(valid), P(res),
                                 m, num_strata, CLUSTER, P(ties),
                                 P(keep),
                                 _build.stream_of(priorities))
    _build.check(lib, rc, what)
    LAUNCHES["fused_select"] += 1
    return keep
