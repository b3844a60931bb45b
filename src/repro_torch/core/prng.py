"""Threefry-2x32 keys and uniforms, bit-exact with ``jax.random``.

The reference draws every priority and coin flip with ``jax.random`` on
the threefry2x32 generator in partitionable mode
(``jax_threefry_partitionable=True``, the default of the jax release the
reference is pinned to). This module reproduces those bits with plain
tensor arithmetic so that whole pipelines compare bitwise:

* ``PRNGKey(seed)``   → ``[0, seed]``
* ``fold_in(key, d)`` → ``threefry(key, (0, d))``
* ``split(key, n)``   → ``threefry(key, iota64(n))`` (hi, lo words)
* ``uniform(key, s)`` → ``bits = y0 ^ y1`` of ``threefry(key,
  iota64(prod(s)))``, then ``(bits >> 9 | 0x3F800000)`` bitcast − 1.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words; every
function broadcasts over leading key dimensions, which is how the
reference's ``vmap`` over per-node keys is written here. Words live in
int64 and are masked with ``0xFFFFFFFF`` after every add and shift, so
the arithmetic is the same on every device.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 hash of the counter words ``(x0, x1)``
    under the key words ``(k0, k1)``. All int64 holding uint32 values;
    the key words broadcast against the counters."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32-range seed: ``[0, seed]``
    (negative seeds wrap to their uint32 pattern, as in the reference)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` (int or integer tensor, taken as
    uint32) broadcasts against the leading dimensions of ``key``."""
    if not torch.is_tensor(data):
        # A fill, not a host-to-device copy: no synchronisation.
        data = torch.full((), int(data) & _MASK, dtype=torch.int64,
                          device=key.device)
    data = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _iota_words(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit iota ``0..n-1`` as (hi, lo) uint32 words."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` → ``[..., num, 2]``."""
    hi, lo = _iota_words(num, key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits`` (as int64) → ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    hi, lo = _iota_words(n, key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return (y0 ^ y1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1), float32 →
    ``key.shape[:-1] + shape``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    # int64 → int32 keeps the low word's bit pattern (values < 2^31 here).
    return bits.to(torch.int32).view(torch.float32) - 1.0
