"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

The port of ``repro/models/moe.py``. Dispatch is sort-free: each
(token, choice)'s slot in its expert's buffer is its running rank in
(token, choice) order (a cumsum over the one-hot routing matrix); pairs
beyond ``capacity = int(max(1, k·T_g/E·capacity_factor))`` are dropped
(GShard/Switch semantics — the residual path carries them). Every kept
pair owns one slot, so the expert buffer is built by an index write and
needs no float atomics (the dropped pairs write to one spare row, which
is cut off). The experts run as one batched matmul over E,
``[E, G·C, d] × [E, d, f]``, whose operations equal the active
parameter count.

*Groups.* The tokens are split into ``G`` groups, one per batch shard of
the mesh (``G = pod·data`` when it divides ``B·S``, else 1), each with
its own capacity ``capacity(cfg, T/G, cf)``: the rank cumsum, the write
into the expert buffers and the gather back stay inside a group. Without
a mesh ``G = 1``; under a stand-in mesh of names and sizes (no
DTensors) one device computes the ``G`` groups that mesh would. The
router, its softmax and the load-balancing loss see all ``T`` tokens.

*Under a model mesh* (``launch.meshctx.use_mesh`` with DTensor
activations) the router and the experts run on DTensors: the tokens are
sharded over the batch axes so that a rank holds its group, the expert
buffer is expert-parallel over "model" when ``E`` divides it (else the
experts are replicated and ``moe_d_ff`` is TP over "model", as the
sharding rules place the weights). DTensor has no sharding rule for the
top-k sort, the one-hot cumsum or the index write and gather, so those
run on each rank's local tokens through ``local_map`` (``select``,
``_dispatch``, ``_combine``), where XLA keeps the reference's group dim
shard-local.

Covers Qwen2-MoE (60 routed top-4 + 4 shared experts fused into one
SwiGLU of width 4·moe_d_ff) and Grok-1 (8 routed top-2, no shared). The
router stays f32 in a bf16 model, as in the reference.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.launch.meshctx import current_mesh, resolve_spec, shard
from repro_torch.launch.sharding import is_dtensor, mesh_sizes, placements
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


def select(gates_full: torch.Tensor, cfg, groups: int, cap: int):
    """Routing on gate probabilities ``[T, E]`` in ``groups`` equal
    groups of tokens → ``(gate_vals [T, k], expert_ix [T, k], slot
    [T, k], keep [T, k], counts [E])``: the top-k experts (equal gates
    in ascending expert order, as ``lax.top_k``), their renormalised
    gates, each pair's rank among its group's pairs routed to the same
    expert, whether that rank is under ``cap``, and how many pairs each
    expert was chosen for."""
    t = gates_full.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    gate_vals, expert_ix = topk_lowest_index(gates_full, k)    # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = F.one_hot(expert_ix.reshape(groups, -1), e)       # [G, Tg·k, E]
    counts = onehot.sum((0, 1))
    ranks = torch.cumsum(onehot, dim=1) - onehot
    slot = (ranks * onehot).sum(-1).reshape(t, k)
    keep = slot < cap
    return gate_vals, expert_ix, slot, keep, counts


def _aux(gates_full: torch.Tensor, counts: torch.Tensor, t: int, cfg):
    """Switch load balancing: ``E · Σ_e fraction_tokens_e · mean_gate_e``."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    me = gates_full.mean(dim=0)
    ce = counts.to(torch.float32) / (t * k)
    return e * torch.sum(me * ce)


def route(p, cfg, xt: torch.Tensor, capacity_factor: float,
          groups: int = 1):
    """The router on tokens ``xt`` ``[T, d]`` in ``groups`` groups →
    ``(gate_vals, expert_ix, slot, keep, aux)`` (``select``'s first four
    and the load-balancing loss over all ``T`` tokens)."""
    t = xt.shape[0]
    gates_full = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
    gate_vals, expert_ix, slot, keep, counts = select(
        gates_full, cfg, groups, capacity(cfg, t // groups, capacity_factor))
    return gate_vals, expert_ix, slot, keep, _aux(gates_full, counts, t, cfg)


def _flat_slots(expert_ix, slot, keep, groups: int, e: int, cap: int):
    """Each pair's row in the ``[G·E·C, d]`` buffer: kept pairs their own
    slot, the others their expert's last slot (read, never written)."""
    t, k = expert_ix.shape
    group = (torch.arange(t, device=expert_ix.device) // (t // groups))
    return ((group[:, None] * e + expert_ix) * cap
            + torch.where(keep, slot, cap - 1)).reshape(-1)


def _dispatch(xt, flat, keep, groups: int, e: int, cap: int):
    """Tokens ``[T, d]`` into the expert buffer ``[G, E, C, d]`` by each
    pair's row ``flat`` (``_flat_slots``): each kept pair's token written
    to its slot (no accumulation), dropped pairs to one spare row that is
    then cut off (a masked write would wait on the device for the kept
    count, and cannot run on ``meta`` tensors)."""
    t, d = xt.shape
    k = keep.shape[1]
    spare = groups * e * cap
    rows = torch.where(keep.reshape(-1), flat, spare)
    token = torch.arange(t, device=xt.device).repeat_interleave(k)
    buf = xt.new_zeros((spare + 1, d)).index_put((rows,), xt[token])
    return buf[:spare].reshape(groups, e, cap, d)


def _combine(out_buf, flat, keep, gate_vals):
    """Each token's kept experts' outputs, gate-weighted: ``[T, d]``."""
    d = out_buf.shape[-1]
    t, k = keep.shape
    gathered = out_buf.reshape(-1, d)[flat].reshape(t, k, d)
    return torch.sum(torch.where(keep[..., None], gathered, 0.0)
                     * gate_vals.to(out_buf.dtype)[..., None], dim=1)


def _swiglu_experts(buf, w_gate, w_up, w_down):
    """``[G, E, C, d]`` through each expert's SwiGLU: one batched matmul
    over E per weight, the groups' slots side by side (a view at
    ``G = 1``)."""
    g, e, c, d = buf.shape
    x = buf.transpose(0, 1).reshape(e, g * c, d)
    h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up)
    return torch.bmm(h, w_down).reshape(e, g, c, -1).transpose(0, 1)


def _experts(p, buf, ep: bool, tok=None):
    """The grouped SwiGLU experts on ``[G, E, C, d]``. On DTensors each
    rank runs its own block (``local_map``): its group's buffer and, EP,
    its experts whole, or, TP, every expert's slice of ``moe_d_ff``,
    whose partial sums the output carries over "model"."""
    if not is_dtensor(buf):
        return _swiglu_experts(buf, p["w_gate"], p["w_up"], p["w_down"])
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = buf.device_mesh
    batch = resolve_spec(tok)[0]
    batch = () if batch is None else (batch if isinstance(batch, tuple)
                                      else (batch,))

    def summed_over(pl, axes):
        # a gradient each rank of ``axes`` holds a part of
        return tuple(Partial() if name in axes else p
                     for name, p in zip(mesh.mesh_dim_names, pl))

    if ep:
        buf_pl = placements(resolve_spec(tok, "expert", None, None), mesh)
        w_in = w_out = placements(resolve_spec("expert", None, None), mesh)
        out_pl = buf_pl_grad = buf_pl
    else:
        buf_pl = placements(resolve_spec(tok, None, None, None), mesh)
        w_in = placements(resolve_spec(None, None, "model"), mesh)
        w_out = placements(resolve_spec(None, "model", None), mesh)
        out_pl = buf_pl_grad = summed_over(buf_pl, ("model",))
    # each batch shard's tokens give a part of every weight's gradient
    w_in_grad, w_out_grad = (summed_over(w, batch) for w in (w_in, w_out))
    return local_map(_swiglu_experts, out_placements=(out_pl,),
                     in_placements=(buf_pl, w_in, w_in, w_out),
                     in_grad_placements=(buf_pl_grad, w_in_grad, w_in_grad,
                                         w_out_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        buf, p["w_gate"], p["w_up"], p["w_down"])


def _mesh_groups(t: int) -> tuple[int, int]:
    """(G, n_model) under the current mesh: G = the batch shards when
    they divide the tokens, else 1."""
    mesh = current_mesh()
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    n_model = sizes.get("model", 1)
    n_batch = sizes.get("pod", 1) * sizes.get("data", 1)
    return (n_batch if t % max(n_batch, 1) == 0 else 1), n_model


def moe_apply(p, cfg, x: torch.Tensor, *, capacity_factor: float = 1.25):
    """x ``[B, S, d]`` → ``([B, S, d], aux load-balancing loss)``, in
    the mesh's ``G`` token groups (1 without a mesh)."""
    x = L.batch_only(x)
    b, s, d = x.shape
    e = cfg.num_experts
    t = b * s
    g, n_model = _mesh_groups(t)
    ep = e % n_model == 0  # expert-parallel vs ffn-TP layout (sharding.py)
    cap = capacity(cfg, t // g, capacity_factor)
    xt = x.reshape(t, d)
    if is_dtensor(xt):
        y, aux = _moe_mesh(p, cfg, xt, g, cap, ep)
    else:
        gate_vals, expert_ix, slot, keep, aux = route(p, cfg, xt,
                                                      capacity_factor, g)
        flat = _flat_slots(expert_ix, slot, keep, g, e, cap)
        out_buf = _experts(p, _dispatch(xt, flat, keep, g, e, cap), ep)
        y = _combine(out_buf, flat, keep, gate_vals)
    if cfg.num_shared_experts:
        y = y + L.swiglu(p["shared"], xt)
    return shard(y.reshape(b, s, d), "batch", None, None), aux


def _moe_mesh(p, cfg, xt, g: int, cap: int, ep: bool):
    """``moe_apply`` on DTensor tokens ``[T, d]``: each rank routes,
    dispatches and combines its own group (``g`` = the batch shards), or
    all tokens as one replicated group (``g = 1``)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = xt.device_mesh
    e = cfg.num_experts
    t = xt.shape[0]
    tok = "batch" if g > 1 else None
    xt = shard(xt, tok, None)
    rows = placements(resolve_spec(tok, None), mesh)           # [T, ·]
    buf_pl = placements(resolve_spec(tok, None, None, None), mesh)
    batch_axes = resolve_spec(tok)[0]
    batch_axes = (() if batch_axes is None else batch_axes
                  if isinstance(batch_axes, tuple) else (batch_axes,))
    summed = tuple(Partial() if name in batch_axes else Replicate()
                   for name in mesh.mesh_dim_names)

    gates_full = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
    gates_full = shard(gates_full, tok, None)
    gate_vals, expert_ix, slot, keep, counts = local_map(
        lambda gl: select(gl, cfg, 1, cap),
        out_placements=(rows, rows, rows, rows, summed),
        in_placements=(rows,), device_mesh=mesh)(gates_full)
    aux = _aux(gates_full, counts, t, cfg)

    buf = local_map(
        lambda xl, il, sl, kl: _dispatch(
            xl, _flat_slots(il, sl, kl, 1, e, cap), kl, 1, e, cap),
        out_placements=(buf_pl,), in_placements=(rows,) * 4,
        device_mesh=mesh)(xt, expert_ix, slot, keep)
    buf = shard(buf, tok, "expert" if ep else None, None, None)
    out_buf = shard(_experts(p, buf, ep, tok), tok, None, None, None)
    y = local_map(
        lambda ol, il, sl, kl, gl: _combine(
            ol, _flat_slots(il, sl, kl, 1, e, cap), kl, gl),
        out_placements=(rows,), in_placements=(buf_pl,) + (rows,) * 4,
        device_mesh=mesh)(out_buf, expert_ix, slot, keep, gate_vals)
    return y, aux
