"""Plain PyTorch versions of causal GQA attention.

``attention`` is the oracle of ``repro/kernels/flash_attention/ref.py``:
it materialises the S×S logits (``repeat`` of the kv heads, ``/ √d``,
``-inf`` mask, softmax in f32, probabilities cast to q's type).

``flash_attention`` is the function the TPU kernel
(``repro/kernels/flash_attention/flash_attention.py``) computes, with its
rounding points: kv and q blocks of ``min(128, S)``; ``s = (q·kᵀ in f32)
* scale`` with ``scale = 1/√d`` multiplied after the dot; the causal mask
at ``-1e30``; ``m``, ``l`` and ``acc`` in f32 with ``alpha = exp(m_prev −
m_cur)``; ``p`` cast to v's type before P·V; ``acc / max(l, 1e-30)`` cast
to q's type. Blocks above the diagonal are skipped, as the kernel skips
them. The CPU path and the tests run it, and the card's kernel
(``csrc/flash_attention.cu``) is held against it.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30
BLOCK = 128


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q ``[B, Hq, S, D]``, k and v ``[B, Hkv, S, D]`` → ``[B, Hq, S, D]``."""
    s, d = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    logits = (torch.einsum("bhqd,bhkd->bhqk", q, kx).to(torch.float32)
              / torch.sqrt(torch.tensor(float(d))))
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, -torch.inf)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), vx)


def block_size(s: int) -> int:
    """The kernel's q and kv block: ``min(128, S)``; raises unless it
    tiles S (the reference asserts the same)."""
    blk = min(BLOCK, s)
    if s < 1 or s % blk:
        raise ValueError(f"flash_attention: seq {s} must tile evenly into "
                         f"blocks of min(128, seq) = {blk}")
    return blk


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's blockwise online softmax, causal, GQA (query head
    ``h`` reads kv head ``h // (Hq/Hkv)``)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads do not group "
                         f"over {hkv} kv heads")
    group = hq // hkv
    scale = 1.0 / (d ** 0.5)
    blk = block_size(s)
    nb = s // blk
    f32 = torch.float32
    # [B, Hkv, G, q block i, row, D]: head h = kv head · G + g.
    qf = q.reshape(b, hkv, group, nb, blk, d).to(f32)
    m = torch.full((b, hkv, group, nb, blk, 1), _NEG_INF, dtype=f32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group, nb, blk, d), dtype=f32,
                      device=q.device)
    tril = torch.ones((blk, blk), dtype=torch.bool, device=q.device).tril()
    for j in range(nb):
        # kv block j updates the q blocks i >= j; the others skip it.
        kj = k[:, :, None, None, j * blk:(j + 1) * blk].to(f32)
        vj = v[:, :, None, None, j * blk:(j + 1) * blk]
        sc = torch.matmul(qf[:, :, :, j:], kj.transpose(-1, -2)) * scale
        sc[:, :, :, 0] = torch.where(tril, sc[:, :, :, 0], _NEG_INF)
        m_prev = m[:, :, :, j:]
        m_cur = torch.maximum(m_prev, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_cur)
        alpha = torch.exp(m_prev - m_cur)
        l[:, :, :, j:] = l[:, :, :, j:] * alpha + p.sum(dim=-1, keepdim=True)
        acc[:, :, :, j:] = acc[:, :, :, j:] * alpha + torch.matmul(
            p.to(v.dtype).to(f32), vj.to(f32))
        m[:, :, :, j:] = m_cur
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.reshape(b, hq, s, d)
