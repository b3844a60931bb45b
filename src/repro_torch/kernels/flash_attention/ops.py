"""Causal GQA attention: the flash kernel, or its plain version.

``flash_attention(q, k, v)``: on a CUDA tensor the wrapper launches
``csrc/flash_attention.cu``; on a CPU tensor it calls the plain version
in ``ref.py``. Any other case raises: there is no fallback from the card
to the plain version.

On the card the dtype alone chooses the kernel: bfloat16 runs the
tensor-core kernel (``wgmma`` fed by TMA loads), float32 the CUDA-core
kernel, since ``wgmma`` has no float32 form and TF32 would round q and k
past the float32 tolerances. A kernel that fails to build or launch
raises; neither stands in for the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, ctypes.c_float, P]
        fn.restype = I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q ``[B, Hq, S, D]``, k and v ``[B, Hkv, S, D]`` → ``[B, Hq, S, D]``
    in q's type; causal; S a multiple of ``min(128, S)``. The kernel has
    no backward (nor has the reference's), so inputs that autograd
    tracks raise, on either device: training runs ``attention_impl=
    "xla"``."""
    _build.plain_only("flash_attention", q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: train with "
            "attention_impl='xla' (the kernel serves prefill only)")
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v)
    what = "flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be [B, Hq, S, D], got "
                         f"{tuple(q.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1] if k.dim() == 4 else 0
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, hkv, s, d):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {(b, hkv, s, d)}")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim must be one of {HEAD_DIMS}, "
                         f"got {d}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{what}: {hq} query heads do not group over "
                         f"{hkv} kv heads")
    ref.block_size(s)
    # TMA reads from 16-byte aligned addresses; a view at an odd offset
    # is copied.
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    o = torch.empty_like(q)
    lib = _lib()
    P = _build.ptr
    rc = lib.flash_attention_launch(
        P(q), P(k), P(v), P(o), b, hq, hkv, s, d,
        int(q.dtype == torch.bfloat16), 1.0 / (d ** 0.5), _build.stream_of(q))
    _build.check(lib, rc, what)
    LAUNCHES["flash_attention"] += 1
    return o
