"""Model API over every family of the zoo: dense, vlm, moe, encdec
(whisper), hybrid (zamba2) and ssm (rwkv6).

    init_params(cfg, seed, device)            → params (a ``Params`` module)
    forward(cfg, params, batch)               → (logits, aux_loss)
    loss_fn(cfg, params, batch)               → (loss, metrics)   [weighted]
    cache_specs(cfg, B, S)                    → the cache as meta tensors
    init_cache(cfg, B, S, device)             → decode cache dict
    build_encdec_cache(cfg, params, frames, S) → encdec cache, cross K/V set
    decode_step(cfg, params, cache, tok, pos) → (logits, cache)

The port of ``repro/models/model.py``. Layer stacks are Python loops
over ``params["layers"]`` (an ``nn.ModuleList``) where the reference
scans stacked parameters; ``cfg.remat`` changes nothing here. Random
init draws from a ``torch.Generator``, so the weights' distributions
match the reference's, not their values; carried weights
(``repro_torch.convert.params_from_numpy``) give the reference's
numbers. Leaves the reference keeps in f32 inside a bf16 model (the moe
router, mamba2's ``a_log``/``dt_bias``/``d_skip``, rwkv6's ``w0`` and
``u_bonus``, the hybrid's SSM state and the ssm family's WKV state) are
f32 here too. Under a model mesh (``launch.meshctx.use_mesh``, DTensor
parameters and batches) the same code runs sharded: the residual stream
between blocks carries the reference's sequence-parallel constraint, and
the loss gathers the vocabulary before its label lookup. The ApproxIoT
data plane enters through ``loss_fn``:
per-example stratum weights from the hierarchical sampler make the loss
an unbiased linear query over the full stream.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.device import resolve_device
from repro_torch.launch.meshctx import shard
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.models.layers import Params

# Leaves that are f32 whatever ``cfg.param_dtype`` says, by name: the
# parameters and the cache entries the reference keeps in f32.
F32_LEAVES = frozenset(MOE.F32_LEAVES + M2.F32_LEAVES + R6.F32_LEAVES)
F32_CACHE = frozenset(("ssm", "wkv"))


def _norm(cfg):
    return L.NORM_APPLY[cfg.norm_type]


def _norm_init(cfg, d=None) -> dict:
    return L.NORM_INIT[cfg.norm_type](d or cfg.d_model, cfg.param_dtype)


def _segments(cfg) -> list[int]:
    """zamba2: mamba-layer segment lengths between shared-attn
    applications; the shared attention follows every segment, the short
    last one too."""
    k = cfg.attn_every
    full, rem = divmod(cfg.num_layers, k)
    return [k] * full + ([rem] if rem else [])


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """``[..., S]`` → ``[..., S, d]`` sinusoidal embedding (whisper's
    stub positional encoding)."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (9.21034 / max(half - 1, 1)))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------------- init --
def _layer_init(cfg, gen: torch.Generator) -> dict:
    """One layer of the family's stack (the decoder's for encdec)."""
    dt = cfg.param_dtype
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return {"ln1": _norm_init(cfg), "attn": L.attention_init(gen, cfg, dt),
                "ln2": _norm_init(cfg),
                "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt)}
    if fam == "moe":
        return {"ln1": _norm_init(cfg), "attn": L.attention_init(gen, cfg, dt),
                "ln2": _norm_init(cfg), "moe": MOE.moe_init(gen, cfg, dt)}
    if fam == "encdec":
        return {"ln1": _norm_init(cfg),
                "self_attn": L.attention_init(gen, cfg, dt),
                "ln_x": _norm_init(cfg),
                "cross_attn": L.attention_init(gen, cfg, dt),
                "ln2": _norm_init(cfg),
                "mlp": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}
    if fam == "hybrid":
        return {"ln": _norm_init(cfg), "mamba": M2.mamba2_init(gen, cfg, dt)}
    if fam == "ssm":
        return {"ln1": L.layernorm_init(cfg.d_model, dt),
                "tm_cm": R6.rwkv6_init(gen, cfg, dt),
                "ln2": L.layernorm_init(cfg.d_model, dt)}
    raise ValueError(fam)


def init_params(cfg, seed: int = 0, device="cuda") -> Params:
    """Random weights from ``torch.Generator().manual_seed(seed)``, drawn
    on the CPU a layer at a time, each layer moved to ``device`` (CUDA
    unless asked otherwise) as soon as it is drawn. On ``"meta"`` the
    leaves have their shapes and types and nothing is drawn (the dry
    run's abstract parameters)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        with torch.device("meta"):
            return _init_params(cfg, None, dev)
    return _init_params(cfg, torch.Generator().manual_seed(seed), dev)


def _init_params(cfg, gen, dev) -> Params:
    dt = cfg.param_dtype

    def placed(tree: dict) -> Params:
        return Params(tree).to(dev)

    p: dict = {"embed": placed(L.embedding_init(gen, cfg.vocab_size,
                                                cfg.d_model, dt))}
    if not cfg.tie_embeddings:
        p["unembed"] = placed(L.unembed_init(gen, cfg.d_model,
                                             cfg.vocab_size, dt))
    p["final_norm"] = placed(_norm_init(cfg))
    if cfg.family == "encdec":
        p["enc_layers"] = [placed({
            "ln1": _norm_init(cfg), "attn": L.attention_init(gen, cfg, dt),
            "ln2": _norm_init(cfg),
            "mlp": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt)})
            for _ in range(cfg.encoder_layers)]
        p["enc_final_norm"] = placed(_norm_init(cfg))
    p["layers"] = [placed(_layer_init(cfg, gen))
                   for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        p["shared_attn"] = placed({"ln": _norm_init(cfg),
                                   "attn": L.attention_init(gen, cfg, dt)})
    return Params(p)


# ---------------------------------------------------------------- forward --
def _sp(t: torch.Tensor) -> torch.Tensor:
    """The sequence-parallel residual (Megatron-SP) between blocks:
    ``[batch, model(seq), -]``, as in the reference."""
    return shard(t, "batch", "model", None)


def _dense_stack(cfg, layers, x: torch.Tensor, positions: torch.Tensor, *,
                 moe: bool = False):
    norm = _norm(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = _sp(x)
    for lp in layers:
        h = norm(lp["ln1"], x)
        x = _sp(x + L.attention(lp["attn"], cfg, h, positions,
                                attn_impl=cfg.attention_impl))
        h = norm(lp["ln2"], x)
        if moe:
            y, a = MOE.moe_apply(lp["moe"], cfg, h,
                                 capacity_factor=cfg.capacity_factor)
            x, aux = _sp(x + y), aux + a
        else:
            x = _sp(x + L.swiglu(lp["mlp"], h))
    return x, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _encdec_encoder(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """The encoder: always non-causal, always the einsum path."""
    b, s_enc, _ = frames.shape
    pos = _positions(b, s_enc, frames.device)
    x = frames + _sinusoid(pos, cfg.d_model).to(frames.dtype)
    norm = _norm(cfg)
    for lp in params["enc_layers"]:
        h = norm(lp["ln1"], x)
        x = x + L.attention(lp["attn"], cfg, h, pos, causal=False,
                            attn_impl="xla")
        h = norm(lp["ln2"], x)
        x = x + L.gelu_mlp(lp["mlp"], h)
    return norm(params["enc_final_norm"], x)


def _encdec_decoder(cfg, params, tokens: torch.Tensor,
                    enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder: causal self-attention as ``cfg.attention_impl`` says,
    then cross-attention to ``enc_out`` on the einsum path."""
    b, s = tokens.shape
    pos = _positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
    norm = _norm(cfg)
    for lp in params["layers"]:
        h = norm(lp["ln1"], x)
        x = x + L.attention(lp["self_attn"], cfg, h, pos, causal=True,
                            attn_impl=cfg.attention_impl)
        h = norm(lp["ln_x"], x)
        x = x + L.attention(lp["cross_attn"], cfg, h, pos, causal=False,
                            kv_x=enc_out)
        h = norm(lp["ln2"], x)
        x = x + L.gelu_mlp(lp["mlp"], h)
    return x


def _hybrid_stack(cfg, params, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    norm = _norm(cfg)
    sa = params["shared_attn"]
    off = 0
    for seg in _segments(cfg):
        for lp in params["layers"][off:off + seg]:
            x = x + M2.mamba2_forward(lp["mamba"], cfg, norm(lp["ln"], x))
        off += seg
        x = x + L.attention(sa["attn"], cfg, norm(sa["ln"], x), positions,
                            causal=True, attn_impl=cfg.attention_impl)
    return x


def _ssm_stack(cfg, params, x: torch.Tensor) -> torch.Tensor:
    b, d = x.shape[0], cfg.d_model
    h = d // cfg.ssm_head_dim
    zero_shift = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    zero_state = torch.zeros((b, h, cfg.ssm_head_dim, cfg.ssm_head_dim),
                             dtype=torch.float32, device=x.device)
    x = _sp(x)
    for lp in params["layers"]:
        y, _, _ = R6.rwkv6_time_mix(lp["tm_cm"], cfg,
                                    L.layernorm(lp["ln1"], x), zero_shift,
                                    zero_state)
        x = _sp(x + y)
        y, _ = R6.rwkv6_channel_mix(lp["tm_cm"], cfg,
                                    L.layernorm(lp["ln2"], x), zero_shift)
        x = _sp(x + y)
    return x


def _head(cfg, params, x: torch.Tensor) -> torch.Tensor:
    x = _norm(cfg)(params["final_norm"], x)
    if cfg.tie_embeddings:
        return shard(L.batch_only(x) @ params["embed"]["table"].T,
                     "batch", None, "model")
    return L.unembed(params["unembed"], x)


def forward(cfg, params: Params, batch: dict):
    """Full-sequence forward: ``batch["tokens"]`` ``[B, S]`` (for vlm
    also ``batch["patches"]`` ``[B, P, d]``, prepended; for encdec
    ``batch["frames"]`` ``[B, S_enc, d]``, the encoder's input) →
    ``(logits [B, S, V], aux_loss)``. ``cfg.attention_impl="pallas"``
    runs the flash kernel in every causal self-attention."""
    fam = cfg.family
    aux = torch.zeros((), dtype=torch.float32,
                      device=batch["tokens"].device)
    if fam == "encdec":
        enc_out = _encdec_encoder(cfg, params, batch["frames"])
        x = _encdec_decoder(cfg, params, batch["tokens"], enc_out)
    else:
        x = L.embed(params["embed"], batch["tokens"])
        if fam == "vlm":
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)
        if fam in ("dense", "vlm", "moe"):
            x, aux = _dense_stack(cfg, params["layers"], x, positions,
                                  moe=fam == "moe")
        elif fam == "hybrid":
            x = _hybrid_stack(cfg, params, x, positions)
        elif fam == "ssm":
            x = _ssm_stack(cfg, params, x)
        else:
            raise ValueError(fam)
    return _head(cfg, params, x), aux


def loss_fn(cfg, params: Params, batch: dict):
    """ApproxIoT-weighted causal LM loss (an unbiased full-stream
    estimate): per-example mean token loss, weighted by
    ``batch["weight"]`` (ones when absent), plus 0.01 × the moe aux
    loss. Labels below 0 carry no loss; vlm patch positions get -1."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    if cfg.family == "vlm":  # patch positions carry no labels
        pad = torch.full((labels.shape[0], cfg.num_patches), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    mask = (labels >= 0).to(torch.float32)
    # the vocab gathered over "model" before the label lookup, which
    # DTensor would otherwise run with the batch gathered too
    logits = shard(logits, "batch", None, None)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1,
                      torch.clamp(labels, min=0).long()[..., None])[..., 0]
    per_tok = -ll * mask
    per_ex = per_tok.sum(-1) / torch.clamp(mask.sum(-1), min=1.0)   # [B]
    w = batch.get("weight")
    if w is None:
        w = torch.ones_like(per_ex)
    loss = torch.sum(w * per_ex) / torch.clamp(torch.sum(w), min=1e-9)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": mask.sum(),
                   "weight_sum": torch.sum(w)}


def build_encdec_cache(cfg, params: Params, frames: torch.Tensor,
                       seq: int, device="cuda") -> dict:
    """Serving helper: run the encoder on ``frames`` ``[B, S_enc, d]``
    and put each decoder layer's cross-attention K/V into a fresh decode
    cache of ``seq`` self-attention slots on ``device`` (CUDA unless
    asked otherwise; the frames and weights must be there). As in the
    reference, the cross K/V take the encoder's length."""
    dev = resolve_device(device)
    if frames.device != dev:
        raise ValueError(f"build_encdec_cache: frames are on "
                         f"{frames.device}, not {dev}; pass "
                         f"device={frames.device.type!r}")
    b = frames.shape[0]
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    with torch.no_grad():
        enc_out = _encdec_encoder(cfg, params, frames)
        cache = init_cache(cfg, b, seq, device=dev)

        def split(t):
            return t.reshape(b, -1, hkv, hd).transpose(1, 2)

        for name, w in (("k_cross", "wk"), ("v_cross", "wv")):
            cache[name] = torch.stack([
                split(enc_out @ lp["cross_attn"][w])
                for lp in params["layers"]]).to(cfg.param_dtype)
    return cache


# ----------------------------------------------------------------- decode --
def cache_specs(cfg, batch: int, seq: int) -> dict:
    """The decode cache as ``meta`` tensors: ``init_cache``'s shapes and
    dtypes, no storage."""
    return init_cache(cfg, batch, seq, device="meta")


def init_cache(cfg, batch: int, seq: int, device="cuda") -> dict:
    """The family's zero decode cache: K/V ``[L, B, Hkv, S, hd]`` in the
    weights' type (encdec adds the cross K/V; the hybrid's are one per
    shared-attention application), the hybrid's conv window and f32 SSM
    state, the ssm family's token shifts and f32 WKV state."""
    dev = resolve_device(device)
    dt = cfg.param_dtype
    hkv, hd, lnum = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    fam = cfg.family

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    kv = (lnum, batch, hkv, seq, hd)
    if fam in ("dense", "vlm", "moe"):
        return {"k": zeros(kv), "v": zeros(kv)}
    if fam == "encdec":
        return {"k": zeros(kv), "v": zeros(kv), "k_cross": zeros(kv),
                "v_cross": zeros(kv)}
    if fam == "hybrid":
        d_inner, n, p_dim, h = M2._dims(cfg)
        n_attn = len(_segments(cfg))
        return {
            "conv": zeros((lnum, batch, M2.CONV_WIDTH - 1, d_inner + 2 * n)),
            "ssm": zeros((lnum, batch, h, n, p_dim), torch.float32),
            "attn_k": zeros((n_attn, batch, hkv, seq, hd)),
            "attn_v": zeros((n_attn, batch, hkv, seq, hd)),
        }
    if fam == "ssm":
        d, k = cfg.d_model, cfg.ssm_head_dim
        return {"tm_shift": zeros((lnum, batch, d)),
                "cm_shift": zeros((lnum, batch, d)),
                "wkv": zeros((lnum, batch, d // k, k, k), torch.float32)}
    raise ValueError(fam)


def decode_step(cfg, params: Params, cache: dict, token: torch.Tensor,
                pos: int):
    """One-token decode: token ``[B, 1]`` → ``(logits [B, V], cache)``.
    Every family's cache is updated in place and returned."""
    fam = cfg.family
    x = L.embed(params["embed"], token)          # [B, 1, d]
    norm = _norm(cfg)

    if fam in ("dense", "vlm", "moe"):
        for i, lp in enumerate(params["layers"]):
            h = norm(lp["ln1"], x)
            a, _, _ = L.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                         cache["v"][i], pos)
            x = x + a
            h = norm(lp["ln2"], x)
            if fam == "moe":
                y, _ = MOE.moe_apply(lp["moe"], cfg, h,
                                     capacity_factor=cfg.capacity_factor)
                x = x + y
            else:
                x = x + L.swiglu(lp["mlp"], h)

    elif fam == "encdec":
        here = torch.full((token.shape[0], 1), pos, device=x.device)
        x = x + _sinusoid(here, cfg.d_model).to(x.dtype)
        for i, lp in enumerate(params["layers"]):
            h = norm(lp["ln1"], x)
            a, _, _ = L.attention_decode(lp["self_attn"], cfg, h,
                                         cache["k"][i], cache["v"][i], pos)
            x = x + a
            h = norm(lp["ln_x"], x)
            a, _, _ = L.attention_decode(lp["cross_attn"], cfg, h,
                                         cache["k_cross"][i],
                                         cache["v_cross"][i], pos,
                                         cross=True)
            x = x + a
            h = norm(lp["ln2"], x)
            x = x + L.gelu_mlp(lp["mlp"], h)

    elif fam == "hybrid":
        sa = params["shared_attn"]
        off = 0
        for i, seg in enumerate(_segments(cfg)):
            for j in range(off, off + seg):
                lp = params["layers"][j]
                y, st = M2.mamba2_decode(
                    lp["mamba"], cfg, norm(lp["ln"], x),
                    {"conv": cache["conv"][j], "ssm": cache["ssm"][j]})
                x = x + y
                cache["conv"][j] = st["conv"]
                cache["ssm"][j] = st["ssm"]
            off += seg
            a, _, _ = L.attention_decode(sa["attn"], cfg, norm(sa["ln"], x),
                                         cache["attn_k"][i],
                                         cache["attn_v"][i], pos)
            x = x + a

    elif fam == "ssm":
        for j, lp in enumerate(params["layers"]):
            y, tm_s, wkv = R6.rwkv6_decode(
                lp["tm_cm"], cfg, L.layernorm(lp["ln1"], x),
                cache["tm_shift"][j], cache["wkv"][j])
            x = x + y
            y, cm_s = R6.rwkv6_channel_mix_decode(
                lp["tm_cm"], cfg, L.layernorm(lp["ln2"], x),
                cache["cm_shift"][j])
            x = x + y
            cache["tm_shift"][j] = tm_s
            cache["cm_shift"][j] = cm_s
            cache["wkv"][j] = wkv
    else:
        raise ValueError(fam)
    return _head(cfg, params, x)[:, 0, :], cache
