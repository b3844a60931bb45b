"""Layer library of the model zoo: norms, RoPE, GQA attention (the
full-sequence path and the one-token decode path), MLPs, embeddings.

The port of ``repro/models/layers.py``. Parameters keep the reference's
names and its ``[d_in, d_out]`` weight layout (``x @ w``), so carrying
weights across is a copy; they live in ``Params`` modules (a nested dict
of tensors as an ``nn.Module``). Activation sharding
(``launch.meshctx.shard``) is a no-op without a mesh and is dropped; the
mesh-only head-repeated attention path waits for model sharding
(ROADMAP Queue 1 item 12b).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops

_MASKED = -1e30


class Params(nn.Module):
    """A nested dict of tensors as a module: ``p["wq"]``,
    ``p["attn"]["q_norm"]``, ``"q_norm" in p``; a list becomes an
    ``nn.ModuleList``, and a module given in the tree is kept as it is.
    Tensors are parameters that take no gradient (serving runs under
    ``torch.inference_mode``); a train step (``optim.train_step``) asks
    for theirs for the length of one step."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, nn.Module):
                self.add_module(name, val)
            elif isinstance(val, dict):
                self.add_module(name, Params(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(name, nn.ModuleList(
                    t if isinstance(t, nn.Module) else Params(t)
                    for t in val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self) -> list[str]:
        return list(self._parameters) + list(self._modules)


def _normal(gen: torch.Generator, shape, dtype, scale: float) -> torch.Tensor:
    """N(0, 1) draws rounded to ``dtype``, times ``scale`` in ``dtype``,
    as the reference's ``jax.random.normal(key, shape, dtype) * scale``;
    the numbers differ from JAX's, the distribution does not."""
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(dtype) * scale


# ----------------------------------------------------------------- norms --
def rmsnorm_init(d: int, dtype) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype)}


def rmsnorm(p, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm_init(d: int, dtype) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def layernorm(p, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


def nonparametric_ln(_, x: torch.Tensor) -> torch.Tensor:
    """OLMo: LayerNorm without learnable scale/bias [arXiv:2402.00838]."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


NORM_INIT = {"rmsnorm": rmsnorm_init, "layernorm": layernorm_init,
             "nonparametric_ln": lambda d, dt: {}}
NORM_APPLY = {"rmsnorm": rmsnorm, "layernorm": layernorm,
              "nonparametric_ln": nonparametric_ln}


# ------------------------------------------------------------------ rope --
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: ``[..., S, D]``; positions: broadcastable to ``[..., S]``. The
    two halves rotate in f32 and the result is cast back."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention --
def attention_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d ** -0.5
    p = {
        "wq": _normal(gen, (d, h * hd), dtype, s),
        "wk": _normal(gen, (d, hkv * hd), dtype, s),
        "wv": _normal(gen, (d, hkv * hd), dtype, s),
        "wo": _normal(gen, (h * hd, d), dtype, (h * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype)
        p["k_norm"] = rmsnorm_init(hd, dtype)
    return p


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def attention(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, kv_x: torch.Tensor | None = None,
              attn_impl: str = "xla") -> torch.Tensor:
    """Attention over the full sequence, x ``[B, S, d]``, positions
    ``[B, S]``; ``kv_x`` ``[B, S_kv, d]`` makes it cross-attention (keys
    and values from ``kv_x``, no RoPE). ``attn_impl="pallas"`` runs the
    flash kernel through ``kernels.flash_attention.ops`` for causal
    self-attention only — on a CUDA tensor it launches the kernel or
    raises; every other call takes the grouped einsum path, f32 logits
    and probabilities cast to x's type, masked only when ``causal``."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    q = _split_heads(x @ p["wq"], h, hd)
    k = _split_heads(src @ p["wk"], hkv, hd)
    v = _split_heads(src @ p["wv"], hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if kv_x is None and cfg.rope_theta > 0:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)

    if attn_impl == "pallas" and causal and kv_x is None:
        o = flash_ops.flash_attention(q, k, v)
        b, _, s, _ = o.shape
        o = o.transpose(1, 2).reshape(b, s, h * hd)
    else:
        # The reference's GQA-native grouped einsum (its path when the kv
        # heads divide the model axis, always so without a mesh): no
        # head-repeated K/V, products of x's type summed in f32.
        group = h // hkv
        b, _, sq_len, _ = q.shape
        f32 = torch.float32
        qg = q.reshape(b, hkv, group, sq_len, hd)
        logits = torch.einsum("bkgqd,bkld->bkgql", qg.to(f32),
                              k.to(f32)) / (hd ** 0.5)
        if causal:
            sq, sk = logits.shape[-2], logits.shape[-1]
            mask = torch.ones((sq, sk), dtype=torch.bool,
                              device=x.device).tril(diagonal=sk - sq)
            logits = torch.where(mask, logits, _MASKED)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.einsum("bkgql,bkld->bkgqd", probs.to(f32),
                         v.to(f32)).to(x.dtype)
        o = o.permute(0, 3, 1, 2, 4).reshape(b, sq_len, h * hd)
    return o @ p["wo"]


def attention_decode(p, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     cross: bool = False):
    """One-token decode against a KV cache, x ``[B, 1, d]``, caches
    ``[B, Hkv, S, hd]``; returns ``(out, k_cache, v_cache)``. The new
    token's K and V are written into the caches IN PLACE at ``pos`` (the
    reference donates its cache and returns a new one). ``cross=True``
    attends to a fixed cross-attention cache: no RoPE, no write, every
    slot valid."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b = x.shape[0]
    q = _split_heads(x @ p["wq"], h, hd)                   # [B, H, 1, hd]
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
    here = torch.full((b, 1, 1), pos, dtype=torch.int32, device=x.device)
    if not cross and cfg.rope_theta > 0:
        q = apply_rope(q, here, cfg.rope_theta)
    if not cross:
        k_new = _split_heads(x @ p["wk"], hkv, hd)         # [B, Hkv, 1, hd]
        v_new = _split_heads(x @ p["wv"], hkv, hd)
        if cfg.qk_norm:
            k_new = rmsnorm(p["k_norm"], k_new)
        if cfg.rope_theta > 0:
            k_new = apply_rope(k_new, here, cfg.rope_theta)
        k_cache[:, :, pos:pos + 1] = k_new.to(k_cache.dtype)
        v_cache[:, :, pos:pos + 1] = v_new.to(v_cache.dtype)

    group = h // hkv
    s_cache = k_cache.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, hkv, group, hd)                      # [B, Hkv, G, hd]
    logits = torch.einsum("bkgd,bksd->bkgs", qg.to(f32),
                          k_cache.to(f32)) / (hd ** 0.5)
    if not cross:
        valid = torch.arange(s_cache, device=x.device) <= pos
        logits = torch.where(valid[None, None, None, :], logits, _MASKED)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", probs.to(k_cache.dtype).to(f32),
                     v_cache.to(f32)).to(x.dtype)
    o = o.reshape(b, 1, h * hd)
    return o @ p["wo"], k_cache, v_cache


# ------------------------------------------------------------------ mlps --
def swiglu_init(gen: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": _normal(gen, (d, d_ff), dtype, d ** -0.5),
        "w_up": _normal(gen, (d, d_ff), dtype, d ** -0.5),
        "w_down": _normal(gen, (d_ff, d), dtype, d_ff ** -0.5),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    return {
        "w_up": _normal(gen, (d, d_ff), dtype, d ** -0.5),
        "b_up": torch.zeros((d_ff,), dtype=dtype),
        "w_down": _normal(gen, (d_ff, d), dtype, d_ff ** -0.5),
        "b_down": torch.zeros((d,), dtype=dtype),
    }


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation.
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


# ------------------------------------------------------------ embeddings --
def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    return {"table": _normal(gen, (vocab, d), dtype, 0.02)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed_init(gen: torch.Generator, d: int, vocab: int, dtype) -> dict:
    return {"w": _normal(gen, (d, vocab), dtype, d ** -0.5)}


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]
