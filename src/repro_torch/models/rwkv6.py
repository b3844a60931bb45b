"""RWKV-6 "Finch" block — data-dependent decay linear attention
[arXiv:2404.05892], chunked-parallel for the full sequence, O(1)-state
decode.

The port of ``repro/models/rwkv6.py``. Recurrence per head (state
S ∈ R^{K×V}):
    y_t = r_t · (S_{t-1} + diag(u) · k_tᵀ v_t)
    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
with per-channel decay  w_t = exp(−exp(w0 + tanh(x̃_t A) B)). Token
shift uses static per-channel mix coefficients, as the reference does.

Chunked form with exclusive log-decay e_t = Σ_{τ<t} log w_τ:
    y_t = (r_t ⊙ exp(e_t))·S_0                        (inter)
        + Σ_{τ<t} [(r_t ⊙ exp(e_t))·(k_τ ⊙ exp(−e_{τ+1}))ᵀ] v_τ   (intra)
        + (r_t ⊙ u ⊙ k_t)·1 v_t                        (bonus diag)
    S_Q = exp(e_{Q+1})·S_0 + (k ⊙ exp(e_{Q+1} − e_next))ᵀ v
All f32 matmuls; the factored exponents are clamped at 30, as in the
reference. The chunks run as a Python loop where the reference scans.
``w0`` and ``u_bonus`` stay f32 in a bf16 model, as does the WKV state.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.launch.meshctx import shard
from repro_torch.models import layers as L

CHUNK = 64
LORA_R = 64
_CLAMP = 30.0  # exp argument clamp for the factored intra-chunk term
_GN_EPS = 64e-5
F32_LEAVES = ("w0", "u_bonus")   # f32 in every model, as in the reference


def rwkv6_init(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    hd = cfg.ssm_head_dim                      # head size (64)
    h = d // hd
    s = d ** -0.5
    f32 = torch.float32

    def half():
        return torch.full((d,), 0.5, dtype=dtype)

    # drawn in the reference's key order: r, k, v, g, o, lora a, lora b,
    # u, then the channel mix's k, v, r
    w = {name: L._normal(gen, (d, d), dtype, s)
         for name in ("w_r", "w_k", "w_v", "w_g", "w_o")}
    lora_a = L._normal(gen, (d, LORA_R), dtype, s)
    lora_b = L._normal(gen, (LORA_R, d), dtype, LORA_R ** -0.5)
    u_bonus = L._normal(gen, (h, hd), f32, 0.1)
    cm_k = L._normal(gen, (d, cfg.d_ff), dtype, s)
    cm_v = L._normal(gen, (cfg.d_ff, d), dtype, cfg.d_ff ** -0.5)
    cm_r = L._normal(gen, (d, d), dtype, s)
    return {
        # time-mix: static token-shift coefficients per projection
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_g": half(),
        "mu_w": half(), **w,
        # data-dependent decay LoRA: w0 + tanh(x A) B
        "w0": torch.full((d,), -2.0, dtype=f32),
        "w_lora_a": lora_a, "w_lora_b": lora_b, "u_bonus": u_bonus,
        "ln_scale": torch.ones((d,), dtype=dtype),
        "ln_bias": torch.zeros((d,), dtype=dtype),
        # channel-mix
        "cm_mu": half(), "cm_k": cm_k, "cm_v": cm_v, "cm_r": cm_r,
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shifted_t = x_{t-1}; position 0 uses carried ``last``. [B,S,d]."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x: torch.Tensor, x_shift: torch.Tensor,
         mu: torch.Tensor) -> torch.Tensor:
    return x + (x_shift - x) * mu  # lerp(x, x_prev, mu)


def _projections(p, x: torch.Tensor, xs: torch.Tensor):
    """r, k, v, the gate g and the log-decay (f32, ≤ 0) of the time mix."""
    r = _mix(x, xs, p["mu_r"]) @ p["w_r"]
    k = _mix(x, xs, p["mu_k"]) @ p["w_k"]
    v = _mix(x, xs, p["mu_v"]) @ p["w_v"]
    g = F.silu(_mix(x, xs, p["mu_g"]) @ p["w_g"])
    xw = _mix(x, xs, p["mu_w"])
    logw = -torch.exp(p["w0"] + (torch.tanh(xw @ p["w_lora_a"])
                                 @ p["w_lora_b"]).to(torch.float32))
    return r, k, v, g, logw


def _group_norm_out(p, y: torch.Tensor, g: torch.Tensor, h: int, hd: int,
                    dtype) -> torch.Tensor:
    """Per-head group norm (population variance, eps 64e-5), then the
    gate and the out-projection."""
    b, s, d = y.shape
    yg = y.reshape(b, s, h, hd)
    mu = yg.mean(-1, keepdim=True)
    var = torch.var(yg, dim=-1, keepdim=True, unbiased=False)
    yg = ((yg - mu) * torch.rsqrt(var + _GN_EPS)).reshape(b, s, d)
    yg = (yg * p["ln_scale"].to(torch.float32)
          + p["ln_bias"].to(torch.float32))
    return (yg * g.to(torch.float32)).to(dtype) @ p["w_o"]


def rwkv6_time_mix(p, cfg, x: torch.Tensor, shift_last: torch.Tensor,
                   state0: torch.Tensor):
    """x ``[B, S, d]``; state0 ``[B, H, K, V]`` f32; S a multiple of
    ``min(CHUNK, S)``. Returns ``(y, shift_out, stateN)``."""
    x = L.batch_only(x)
    b, s, d = x.shape
    hd = cfg.ssm_head_dim
    h = d // hd
    q = min(CHUNK, s)
    if s % q:
        raise ValueError(f"rwkv6_time_mix: sequence length {s} is not a "
                         f"multiple of the chunk {q}")
    nc = s // q
    f32 = torch.float32

    r, k, v, g, logw = _projections(p, x, _token_shift(x, shift_last))

    def heads(t):  # [B,S,d] → [B,nc,Q,H,hd] f32
        return t.to(f32).reshape(b, nc, q, h, hd)

    rh, kh, vh, lw = heads(r), heads(k), heads(v), heads(logw)
    u = p["u_bonus"]                                           # [H,hd]
    strict = torch.ones((q, q), dtype=torch.bool,
                        device=x.device).tril(diagonal=-1)

    state = state0
    ys = []
    for c in range(nc):
        # Heads shard over TP; the [B,H,K,V] chunk state stays
        # head-sharded too, as in the reference.
        r_c, k_c, v_c, lw_c = (shard(t[:, c], "batch", None, "model", None)
                               for t in (rh, kh, vh, lw))
        state = shard(state, "batch", "model", None, None)
        e_inc = torch.cumsum(lw_c, dim=1)          # inclusive Σ_{τ≤t}
        e_exc = e_inc - lw_c                       # exclusive Σ_{τ<t}
        e_tot = e_inc[:, -1:, :, :]                # [B,1,H,K]

        r_dec = r_c * torch.exp(e_exc)                             # [B,Q,H,K]
        k_dec = k_c * torch.exp(torch.clamp(-e_inc, max=_CLAMP))
        att = torch.einsum("bqhk,bthk->bhqt", r_dec, k_dec)        # [B,H,Q,Q]
        att = torch.where(strict[None, None], att, 0.0)
        y_intra = torch.einsum("bhqt,bthv->bqhv", att, v_c)
        bonus = torch.einsum("bqhk,bqhk->bqh", r_c * u[None, None], k_c)
        y_bonus = bonus[..., None] * v_c
        y_inter = torch.einsum("bqhk,bhkv->bqhv", r_dec, state)
        k_scaled = k_c * torch.exp(torch.clamp(e_tot - e_inc, max=_CLAMP))
        ds = torch.einsum("bqhk,bqhv->bhkv", k_scaled, v_c)
        state = torch.exp(e_tot[:, 0])[..., None] * state + ds
        ys.append(y_intra + y_inter + y_bonus)
    y = torch.stack(ys, dim=1).reshape(b, s, d)
    return (shard(_group_norm_out(p, y, g, h, hd, x.dtype), "batch", None,
                  None), x[:, -1, :], state)


def rwkv6_channel_mix(p, cfg, x: torch.Tensor, shift_last: torch.Tensor):
    x = L.batch_only(x)
    xs = _token_shift(x, shift_last)
    xk = _mix(x, xs, p["cm_mu"])
    kk = shard(torch.square(torch.relu(xk @ p["cm_k"])), "batch", None,
               "model")
    r = torch.sigmoid(x @ p["cm_r"])
    return shard(r * (kk @ p["cm_v"]), "batch", None, None), x[:, -1, :]


def rwkv6_init_state(cfg, batch: int, dtype=torch.float32,
                     device="cpu") -> dict:
    d = cfg.d_model
    hd = cfg.ssm_head_dim
    h = d // hd
    return {
        "tm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                           device=device),
    }


def rwkv6_decode(p, cfg, x: torch.Tensor, tm_shift: torch.Tensor,
                 wkv_state: torch.Tensor):
    """One-token time-mix decode. x ``[B, 1, d]`` → ``(out, new_shift,
    new_wkv)``."""
    b, _, d = x.shape
    hd = cfg.ssm_head_dim
    h = d // hd
    f32 = torch.float32
    r, k, v, g, logw = _projections(p, x, tm_shift[:, None, :])
    rh = r.to(f32).reshape(b, h, hd)
    kh = k.to(f32).reshape(b, h, hd)
    vh = v.to(f32).reshape(b, h, hd)
    w = torch.exp(logw.reshape(b, h, hd))
    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    y = torch.einsum("bhk,bhkv->bhv", rh,
                     wkv_state + p["u_bonus"][..., None] * kv)
    wkv = w[..., None] * wkv_state + kv
    out = _group_norm_out(p, y.reshape(b, 1, d), g, h, hd, x.dtype)
    return out, x[:, -1, :], wkv


def rwkv6_channel_mix_decode(p, cfg, x: torch.Tensor,
                             shift_last: torch.Tensor):
    """One-token channel mix. x ``[B, 1, d]`` → ``(out, new_shift)``."""
    xs = shift_last[:, None, :]
    xk = _mix(x, xs, p["cm_mu"])
    kk = torch.square(torch.relu(xk @ p["cm_k"]))
    r = torch.sigmoid(x @ p["cm_r"])
    return r * (kk @ p["cm_v"]), x[:, -1, :]
