"""Layer library of the model zoo: norms, RoPE, GQA attention (the
full-sequence path and the one-token decode path), MLPs, embeddings.

The port of ``repro/models/layers.py``. Parameters keep the reference's
names and its ``[d_in, d_out]`` weight layout (``x @ w``), so carrying
weights across is a copy; they live in ``Params`` modules (a nested dict
of tensors as an ``nn.Module``). Activations carry the reference's
logical sharding constraints (``launch.meshctx.shard``): the identity
without a mesh, a DTensor redistribution under one. Under a model mesh
attention lays out its heads as the reference's mesh-aware branch does
(kv heads sharded when they divide the "model" axis, each rank's block
of query heads reading its block of kv heads; else K/V repeated to every
query head and the heads sharded, padded with zeros where "model" does
not divide them), and each rank runs the core on its own batch and
heads: the flash kernel for causal self-attention with
``attn_impl="pallas"``, on the rank's plain local tensors (its wrapper
takes no DTensor), else the einsum core.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.meshctx import current_mesh, shard
from repro_torch.launch.sharding import mesh_sizes

_MASKED = -1e30


class Params(nn.Module):
    """A nested dict of tensors as a module: ``p["wq"]``,
    ``p["attn"]["q_norm"]``, ``"q_norm" in p``; a list becomes an
    ``nn.ModuleList``, and a module given in the tree is kept as it is.
    Tensors are parameters that take no gradient (serving runs under
    ``torch.inference_mode``); a train step (``optim.train_step``) asks
    for theirs for the length of one step. Under a model mesh, ``p[name]``
    reads a DTensor parameter gathered over its FSDP axes
    (``_fsdp_gathered``)."""

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
        t = getattr(self, name)
        return t if current_mesh() is None else _fsdp_gathered(t)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self) -> list[str]:
        return list(self._parameters) + list(self._modules)


def _fsdp_gathered(t):
    """A weight as the model reads it: under a model mesh a DTensor
    parameter is all-gathered over the batch axes ("pod", "data"), where
    FSDP keeps it sharded, and keeps its "model" (TP) placement; its
    gradient goes back as a reduce-scatter over the same axes. Anything
    else as it is."""
    if not isinstance(t, nn.Parameter):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names
    want = tuple(Replicate() if n in ("pod", "data") else pl
                 for n, pl in zip(names, t.placements))
    return t.redistribute(t.device_mesh, want)


def _normal(gen: torch.Generator, shape, dtype, scale: float) -> torch.Tensor:
    """N(0, 1) draws rounded to ``dtype``, times ``scale`` in ``dtype``,
    as the reference's ``jax.random.normal(key, shape, dtype) * scale``;
    the numbers differ from JAX's, the distribution does not."""
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(dtype) * scale


def batch_only(x: torch.Tensor) -> torch.Tensor:
    """An activation ``[B, S, ...]`` (or ``[T, ...]``) with only its
    batch dim sharded. At a block's input it gathers the
    sequence-parallel residual's "model" split before a projection
    (Megatron-SP's all-gather); at a block's output it sums the TP
    partial products, so that the gradient coming back from the residual
    is gathered too. Either way DTensor flattens the tokens (forward and
    backward) with the batch alone split, which every torch version's
    view rules take."""
    return shard(x, "batch", *([None] * (x.ndim - 1)))


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


def _per_rank(fn, *ts: torch.Tensor) -> torch.Tensor:
    """``fn`` on each rank's local tensors of DTensors, the result placed
    as the first (``fn`` must contract, reshape or cut no sharded dim);
    on plain tensors ``fn(*ts)``. For the attention core and the head
    padding, which DTensor's own rules would run by flattening sharded
    dims (refused by some torch versions) or not carry at all."""
    from torch.distributed.tensor import DTensor

    if not isinstance(ts[0], DTensor):
        return fn(*ts)
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=(tuple(ts[0].placements),),
                     in_placements=tuple(tuple(t.placements) for t in ts),
                     device_mesh=ts[0].device_mesh)(*ts)


def _whole_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``x`` with its head dims gathered over "model" when that axis
    cannot split whole heads (DTensor cannot view a dim sharded
    unevenly)."""
    mesh = current_mesh()
    if mesh is not None and n_heads % mesh_sizes(mesh).get("model", 1):
        return shard(x, "batch", *([None] * (x.ndim - 1)))
    return x


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    x = _whole_heads(x, n_heads)
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def attention(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, kv_x: torch.Tensor | None = None,
              attn_impl: str = "xla") -> torch.Tensor:
    """Attention over the full sequence, x ``[B, S, d]``, positions
    ``[B, S]``; ``kv_x`` ``[B, S_kv, d]`` makes it cross-attention (keys
    and values from ``kv_x``, no RoPE). ``attn_impl="pallas"`` runs the
    flash kernel through ``kernels.flash_attention.ops`` for causal
    self-attention, under a model mesh on every rank's own batch and
    heads; on a CUDA tensor it launches the kernel or raises. Every
    other call takes the einsum core: f32 logits and probabilities cast
    to x's type, masked only when ``causal``."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = batch_only(x)
    src = x if kv_x is None else batch_only(kv_x)
    q = _split_heads(x @ p["wq"], h, hd)
    k = _split_heads(src @ p["wk"], hkv, hd)
    v = _split_heads(src @ p["wv"], hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if kv_x is None and cfg.rope_theta > 0:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)

    flash = attn_impl == "pallas" and causal and kv_x is None
    mesh = current_mesh()
    n_model = mesh_sizes(mesh).get("model", 1) if mesh is not None else 1
    group = h // hkv
    b, _, sq_len, _ = q.shape
    if hkv % max(n_model, 1) == 0:
        # The reference's TP strategy, mesh-aware: kv heads dividing the
        # model axis (always so without a mesh) → GQA-native, heads
        # sharded, no head-repeated K/V; otherwise K/V repeated to every
        # query head and the heads sharded. The core runs per rank: the
        # flash kernel (still GQA on the grouped layout) or the einsums,
        # products of x's type summed in f32.
        qg = shard(q.reshape(b, hkv, group, sq_len, hd),
                   "batch", "model", None, None, None)
        k = shard(k, "batch", "model", None, None)
        v = shard(v, "batch", "model", None, None)
        o = _per_rank(_grouped_flash if flash else (
            lambda qq, kk, vv: _scores_then_values(
                "bkgqd,bkld->bkgql", "bkgql,bkld->bkgqd", qq, kk, vv,
                causal, x.dtype)), qg, k, v)
        o = o.permute(0, 3, 1, 2, 4).reshape(b, sq_len, h * hd)
    else:
        # heads padded with zeros to a multiple of the model axis and
        # sharded evenly, as XLA pads an uneven head sharding; the
        # padding is cut off before the out-projection
        pad = (-h) % max(n_model, 1)

        def heads(t):
            if pad:
                t = _per_rank(lambda u: F.pad(u, (0, 0, 0, 0, 0, pad)),
                              shard(t, "batch", None, None, None))
            return shard(t, "batch", "model", None, None)

        kx = heads(torch.repeat_interleave(k, group, dim=1))
        vx = heads(torch.repeat_interleave(v, group, dim=1))
        o = _per_rank(flash_ops.flash_attention if flash else (
            lambda qq, kk, vv: _scores_then_values(
                "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd", qq, kk, vv, causal,
                x.dtype)), heads(q), kx, vx)
        if pad:
            o = _per_rank(lambda u: u[:, :h],
                          shard(o, "batch", None, None, None))
        o = _whole_heads(o.transpose(1, 2).reshape(b, sq_len, h * hd), h)
    return batch_only(o @ p["wo"])


def _grouped_flash(qg, k, v) -> torch.Tensor:
    """The flash kernel on one rank's grouped blocks: q ``[B, Hkv, G, S,
    D]`` (kv-major, so its ``Hkv·G`` query heads read its ``Hkv`` kv
    heads) and k, v ``[B, Hkv, S, D]``; the output in q's layout."""
    b, hkv, g, s, d = qg.shape
    o = flash_ops.flash_attention(qg.reshape(b, hkv * g, s, d), k, v)
    return o.reshape(b, hkv, g, s, d)


def _scores_then_values(scores: str, values: str, q, k, v, causal: bool,
                        dtype) -> torch.Tensor:
    """``softmax(q·kᵀ/√d) · v`` by the two einsums named: products of
    the operands' type summed in f32, probabilities cast to ``dtype``.
    Under a mesh each rank runs it on its own batch and heads, which it
    contracts neither of."""
    f32 = torch.float32
    logits = torch.einsum(scores, q.to(f32), k.to(f32)) / (q.shape[-1] ** 0.5)
    probs = torch.softmax(_causal(logits, causal, q.device),
                          dim=-1).to(dtype)
    return torch.einsum(values, probs.to(f32), v.to(f32)).to(dtype)


def _causal(logits: torch.Tensor, causal: bool, device) -> torch.Tensor:
    """``logits [..., Sq, Sk]`` with the future masked when ``causal``
    (query ``i`` sees keys up to ``i + Sk − Sq``)."""
    if not causal:
        return logits
    sq, sk = logits.shape[-2], logits.shape[-1]
    mask = torch.ones((sq, sk), dtype=torch.bool,
                      device=device).tril(diagonal=sk - sq)
    return torch.where(mask, logits, _MASKED)


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
    qg = _whole_heads(q, hkv).reshape(b, hkv, group, hd)   # [B, Hkv, G, hd]
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
    x = batch_only(x)
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    # [B, S, f], or [T, f] for the moe's shared expert on its tokens
    h = shard(h, "batch", *([None] * (h.ndim - 2)), "model")
    return batch_only(h @ p["w_down"])


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    return {
        "w_up": _normal(gen, (d, d_ff), dtype, d ** -0.5),
        "b_up": torch.zeros((d_ff,), dtype=dtype),
        "w_down": _normal(gen, (d_ff, d), dtype, d_ff ** -0.5),
        "b_down": torch.zeros((d,), dtype=dtype),
    }


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation.
    x = batch_only(x)
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    h = shard(h, "batch", None, "model")
    return batch_only(h @ p["w_down"]) + p["b_down"]


# ------------------------------------------------------------ embeddings --
def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    return {"table": _normal(gen, (vocab, d), dtype, 0.02)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    table = p["table"]
    from torch.distributed.tensor import DTensor

    if isinstance(table, DTensor):
        return shard(_lookup_per_rank(table, tokens), "batch", None, None)
    return shard(table[tokens], "batch", None, None)


def _lookup_per_rank(table, tokens):
    """The embedding lookup under a mesh: each rank looks its own tokens
    up in the whole table (gathered), and the table's gradient is the sum
    over the ranks the tokens are split across (DTensor's rule for the
    lookup's backward, an accumulating index write, is not carried by
    every torch version)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok = tuple(tokens.placements)
    whole = (Replicate(),) * mesh.ndim
    summed = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                   for pl in tok)
    return local_map(lambda t, i: t[i], out_placements=(tok,),
                     in_placements=(whole, tok),
                     in_grad_placements=(summed, tok), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def unembed_init(gen: torch.Generator, d: int, vocab: int, dtype) -> dict:
    return {"w": _normal(gen, (d, vocab), dtype, d ** -0.5)}


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return shard(batch_only(x) @ p["w"], "batch", None, "model")
