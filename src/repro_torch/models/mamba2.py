"""Mamba2 (SSD) block — chunked parallel scan for the full sequence,
O(1)-state recurrence for decode.

The port of ``repro/models/mamba2.py``: the scalar-A-per-head SSD
formulation [Dao & Gu 2024], n_groups=1 (B/C shared across heads).

Chunked form (chunk length Q, log-decay l_t = Σ_{τ≤t} log a_τ per head):
    Y_intra = (C Bᵀ ∘ M) x̃            M_{tτ} = exp(l_t − l_τ), τ ≤ t
    Y_inter =  C · exp(l_t) · S_prev
    S_next  =  exp(l_Q)·S_prev + Σ_τ exp(l_Q − l_τ)·B_τ ⊗ x̃_τ
All decay algebra in f32 log space; every contraction is a matmul. The
chunks run as a Python loop where the reference scans. ``a_log``,
``dt_bias`` and ``d_skip`` stay f32 in a bf16 model, as does the SSM
state.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.launch.meshctx import shard
from repro_torch.models import layers as L

CONV_WIDTH = 4
CHUNK = 128
_MASKED = -1e30
F32_LEAVES = ("a_log", "dt_bias", "d_skip")   # f32 in every model


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns into the
    # identity above its threshold.
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _dims(cfg) -> tuple[int, int, int, int]:
    d_inner = 2 * cfg.d_model
    n, p_dim = cfg.ssm_state, cfg.ssm_head_dim
    return d_inner, n, p_dim, d_inner // p_dim


def mamba2_init(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    d_inner, n, _, h = _dims(cfg)
    conv_dim = d_inner + 2 * n
    f32 = torch.float32
    return {
        # fused in_proj → [z, x, B, C, dt]
        "w_in": L._normal(gen, (d, 2 * d_inner + 2 * n + h), dtype,
                          d ** -0.5),
        "conv_w": L._normal(gen, (CONV_WIDTH, conv_dim), dtype, 0.3),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32)),
        "dt_bias": torch.zeros((h,), dtype=f32),
        "d_skip": torch.ones((h,), dtype=f32),
        "norm_scale": torch.ones((d_inner,), dtype=dtype),
        "w_out": L._normal(gen, (d_inner, d), dtype, d_inner ** -0.5),
    }


def _split_proj(cfg, proj: torch.Tensor):
    d_inner, n, _, h = _dims(cfg)
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * n, h], dim=-1)
    return z, xbc, dt  # dt: [..., H]


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width 4, over ``[B, S, conv_dim]``: the
    reference's sum of shifted products, in its order."""
    s = xbc.shape[1]
    pads = F.pad(xbc, (0, 0, CONV_WIDTH - 1, 0))
    out = 0
    for i in range(CONV_WIDTH):
        out = out + pads[:, i:i + s, :] * conv_w[i][None, None, :]
    return F.silu(out + conv_b)


def _gated_norm_out(p, y: torch.Tensor, z: torch.Tensor,
                    dtype) -> torch.Tensor:
    """Gated RMSNorm in f32, then the out-projection in ``dtype``."""
    y = y * F.silu(z.to(torch.float32))
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * p["norm_scale"].to(torch.float32)
    return y.to(dtype) @ p["w_out"]


def mamba2_forward(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """The full-sequence path. x ``[B, S, d]`` → ``[B, S, d]``; S a
    multiple of ``min(CHUNK, S)``."""
    x = L.batch_only(x)
    b, s, _ = x.shape
    d_inner, n, p_dim, h = _dims(cfg)
    q = min(CHUNK, s)
    if s % q:
        raise ValueError(f"mamba2_forward: sequence length {s} is not a "
                         f"multiple of the chunk {q}")
    nc = s // q
    f32 = torch.float32

    z, xbc, dt = _split_proj(cfg, x @ p["w_in"])
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)

    dt = _softplus(dt.to(f32) + p["dt_bias"])                  # [B,S,H]
    a = -torch.exp(p["a_log"])                                 # [H] < 0
    log_decay = dt * a                                         # [B,S,H] ≤ 0

    xh = xs.reshape(b, s, h, p_dim)
    xt = (xh.to(f32) * dt[..., None]).reshape(b, nc, q, h, p_dim)
    bm = bmat.to(f32).reshape(b, nc, q, n)
    cm = cmat.to(f32).reshape(b, nc, q, n)
    ld = log_decay.reshape(b, nc, q, h)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()

    state = torch.zeros((b, h, n, p_dim), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        bm_c, cm_c, xt_c = bm[:, c], cm[:, c], xt[:, c]
        l = torch.cumsum(ld[:, c], dim=1)          # inclusive  [B,Q,H]
        l_total = l[:, -1:, :]                     # [B,1,H]
        scores = torch.einsum("bqn,bkn->bqk", cm_c, bm_c)      # [B,Q,Q]
        gap = l[:, :, None, :] - l[:, None, :, :]              # [B,Q,Q,H]
        # mask the *argument* (exp(-1e30) = 0): masking the result would
        # take 0·inf = NaN through the upper triangle's gradients.
        m = torch.exp(torch.where(causal[None, :, :, None], gap, _MASKED))
        y_intra = torch.einsum("bqk,bqkh,bkhp->bqhp", scores, m, xt_c)
        y_inter = torch.einsum("bqn,bqh,bhnp->bqhp", cm_c, torch.exp(l),
                               state)
        w_in = torch.exp(l_total - l)                          # [B,Q,H]
        ds = torch.einsum("bqn,bqh,bqhp->bhnp", bm_c, w_in, xt_c)
        state = torch.exp(l_total[:, 0, :, None, None]) * state + ds
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p_dim)
    y = y + xh.to(f32) * p["d_skip"][None, None, :, None]
    return shard(_gated_norm_out(p, y.reshape(b, s, d_inner), z, x.dtype),
                 "batch", None, None)


def mamba2_init_state(cfg, batch: int, dtype=torch.float32,
                      device="cpu") -> dict:
    d_inner, n, p_dim, h = _dims(cfg)
    return {
        "conv": torch.zeros((batch, CONV_WIDTH - 1, d_inner + 2 * n),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, n, p_dim), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(p, cfg, x: torch.Tensor, state: dict):
    """One-token decode. x ``[B, 1, d]`` → ``([B, 1, d], new state)``;
    the state's tensors are new, not updated in place."""
    b = x.shape[0]
    d_inner, n, p_dim, h = _dims(cfg)
    f32 = torch.float32

    z, xbc, dt = _split_proj(cfg, x @ p["w_in"])
    window = torch.cat([state["conv"], xbc], dim=1)            # [B, W, conv]
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"])
                      + p["conv_b"])[:, None, :]
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)

    dtv = _softplus(dt[:, 0].to(f32) + p["dt_bias"])           # [B,H]
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dtv * a)                                 # [B,H]
    xh = xs[:, 0].reshape(b, h, p_dim).to(f32) * dtv[..., None]
    ssm = decay[..., None, None] * state["ssm"] + torch.einsum(
        "bn,bhp->bhnp", bmat[:, 0].to(f32), xh)
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].to(f32), ssm)
    y = y + xs[:, 0].reshape(b, h, p_dim).to(f32) * p["d_skip"][:, None]
    out = _gated_norm_out(p, y.reshape(b, 1, d_inner), z, x.dtype)
    return out, {"conv": window[:, 1:, :], "ssm": ssm}

