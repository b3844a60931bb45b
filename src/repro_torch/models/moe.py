"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

The port of ``repro/models/moe.py``. Dispatch is sort-free: each
(token, choice)'s slot in its expert's buffer is its running rank in
(token, choice) order (a cumsum over the one-hot routing matrix); pairs
beyond ``capacity = int(max(1, k·T/E·capacity_factor))`` are dropped
(GShard/Switch semantics — the residual path carries them). Every kept
pair owns one slot, so the expert buffer is built by an index write and
needs no float atomics. The experts run as one batched matmul
``[E, C, d] × [E, d, f]``, whose operations equal the active parameter
count.

The reference splits the tokens into ``G`` groups, one per batch shard
of its mesh, with a capacity per group. The port has no model mesh yet
(ROADMAP Queue 1 item 12b), so ``G = 1``, the reference's value without
a mesh: one group of all ``B·S`` tokens.

Covers Qwen2-MoE (60 routed top-4 + 4 shared experts fused into one
SwiGLU of width 4·moe_d_ff) and Grok-1 (8 routed top-2, no shared). The
router stays f32 in a bf16 model, as in the reference.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.models import layers as L
from repro_torch.query.sketches import topk_lowest_index

F32_LEAVES = ("router",)     # f32 in every model, as in the reference


def moe_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": L._normal(gen, (d, e), torch.float32, d ** -0.5),
        "w_gate": L._normal(gen, (e, d, f), dtype, d ** -0.5),
        "w_up": L._normal(gen, (e, d, f), dtype, d ** -0.5),
        "w_down": L._normal(gen, (e, f, d), dtype, f ** -0.5),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.swiglu_init(gen, d, cfg.num_shared_experts * f, dtype)
    return p


def capacity(cfg, tokens: int, capacity_factor: float) -> int:
    """Slots per expert for ``tokens`` tokens in one group."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    return int(max(1, (k * tokens / e) * capacity_factor))


def route(p, cfg, xt: torch.Tensor, capacity_factor: float):
    """The router on tokens ``xt`` ``[T, d]`` → ``(gate_vals [T, k],
    expert_ix [T, k], slot [T, k], keep [T, k], aux)``: the top-k experts
    (equal gates in ascending expert order, as ``lax.top_k``), their
    renormalised gates, each pair's rank among the pairs routed to the
    same expert, whether that rank is under the capacity, and the Switch
    load-balancing loss ``E · Σ_e fraction_tokens_e · mean_gate_e``."""
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = xt.to(torch.float32) @ p["router"]                # [T, E]
    gates_full = torch.softmax(logits, dim=-1)
    gate_vals, expert_ix = topk_lowest_index(gates_full, k)    # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    me = gates_full.mean(dim=0)
    ce = torch.bincount(expert_ix.reshape(-1), minlength=e).to(
        torch.float32) / (t * k)
    aux = e * torch.sum(me * ce)
    onehot = F.one_hot(expert_ix.reshape(-1), e)               # [T·k, E]
    ranks = torch.cumsum(onehot, dim=0) - onehot
    slot = (ranks * onehot).sum(-1).reshape(t, k)
    keep = slot < capacity(cfg, t, capacity_factor)
    return gate_vals, expert_ix, slot, keep, aux


def moe_apply(p, cfg, x: torch.Tensor, *, capacity_factor: float = 1.25):
    """x ``[B, S, d]`` → ``([B, S, d], aux load-balancing loss)``."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    xt = x.reshape(t, d)
    gate_vals, expert_ix, slot, keep, aux = route(p, cfg, xt,
                                                  capacity_factor)
    cap = capacity(cfg, t, capacity_factor)

    # Each kept (token, choice) owns slot ``expert · C + slot``: an index
    # write, no accumulation.
    flat = (expert_ix * cap + torch.where(keep, slot, cap - 1)).reshape(-1)
    kept = keep.reshape(-1)
    token = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = x.new_zeros((e * cap, d))
    buf = buf.index_put((flat[kept],), xt[token[kept]])
    buf = buf.reshape(e, cap, d)

    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).reshape(e * cap, d)    # [E·C, d]

    gathered = out_buf[flat].reshape(t, k, d)
    y = torch.sum(torch.where(keep[..., None], gathered, 0.0)
                  * gate_vals.to(x.dtype)[..., None], dim=1)
    if cfg.num_shared_experts:
        y = y + L.swiglu(p["shared"], xt)
    return y.reshape(b, s, d), aux
