"""Model API of the zoo's serving half, the dense and vlm families.

    init_params(cfg, seed, device)            → params (a ``Params`` module)
    forward(cfg, params, batch)               → (logits, aux_loss)
    init_cache(cfg, B, S, device)             → decode cache dict
    decode_step(cfg, params, cache, tok, pos) → (logits, cache)

The port of ``repro/models/model.py``. The layer stack is a Python loop
over ``params["layers"]`` (an ``nn.ModuleList``) where the reference scans
stacked parameters; ``cfg.remat`` changes nothing at inference. Random
init draws from a ``torch.Generator``, so the weights' distributions
match the reference's, not their values; carried weights
(``repro_torch.convert.params_from_numpy``) give the reference's numbers.
The moe, encdec, hybrid and ssm families raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import Params

FAMILIES = ("dense", "vlm")


def _unported(cfg) -> NotImplementedError:
    return NotImplementedError(
        f"the {cfg.family!r} family ({cfg.name}) is not ported yet: the "
        f"moe, encdec, hybrid and ssm families come next in ROADMAP.md "
        f"Queue 1 item 13; dense and vlm run")


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise _unported(cfg)


def _norm(cfg):
    return L.NORM_APPLY[cfg.norm_type]


def _norm_init(cfg, d=None) -> dict:
    return L.NORM_INIT[cfg.norm_type](d or cfg.d_model, cfg.param_dtype)


# ------------------------------------------------------------------- init --
def init_params(cfg, seed: int = 0, device="cuda") -> Params:
    """Random weights from ``torch.Generator().manual_seed(seed)``, drawn
    on the CPU and moved to ``device`` (CUDA unless asked otherwise)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.param_dtype
    p: dict = {"embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = L.unembed_init(gen, cfg.d_model, cfg.vocab_size, dt)
    p["final_norm"] = _norm_init(cfg)
    p["layers"] = [{
        "ln1": _norm_init(cfg), "attn": L.attention_init(gen, cfg, dt),
        "ln2": _norm_init(cfg),
        "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt),
    } for _ in range(cfg.num_layers)]
    return Params(p).to(dev)


# ---------------------------------------------------------------- forward --
def _dense_stack(cfg, layers, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    norm = _norm(cfg)
    for lp in layers:
        h = norm(lp["ln1"], x)
        x = x + L.attention(lp["attn"], cfg, h, positions,
                            attn_impl=cfg.attention_impl)
        h = norm(lp["ln2"], x)
        x = x + L.swiglu(lp["mlp"], h)
    return x


def _head(cfg, params, x: torch.Tensor) -> torch.Tensor:
    x = _norm(cfg)(params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return L.unembed(params["unembed"], x)


def forward(cfg, params: Params, batch: dict):
    """Full-sequence forward: ``batch["tokens"]`` ``[B, S]`` (and for vlm
    ``batch["patches"]`` ``[B, P, d]``, prepended) → ``(logits [B, S, V],
    aux_loss)``. ``cfg.attention_impl="pallas"`` runs the flash kernel."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = _dense_stack(cfg, params["layers"], x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(cfg, params, x), aux


# ----------------------------------------------------------------- decode --
def init_cache(cfg, batch: int, seq: int, device="cuda") -> dict:
    """Zero K/V caches ``[L, B, Hkv, S, hd]`` in the weights' type."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, seq, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev)}


def decode_step(cfg, params: Params, cache: dict, token: torch.Tensor,
                pos: int):
    """One-token decode: token ``[B, 1]`` → ``(logits [B, V], cache)``.
    The cache is updated in place at ``pos`` and returned."""
    _check_family(cfg)
    x = L.embed(params["embed"], token)          # [B, 1, d]
    norm = _norm(cfg)
    for i, lp in enumerate(params["layers"]):
        h = norm(lp["ln1"], x)
        a, _, _ = L.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                     cache["v"][i], pos)
        x = x + a
        h = norm(lp["ln2"], x)
        x = x + L.swiglu(lp["mlp"], h)
    return _head(cfg, params, x)[:, 0, :], cache
