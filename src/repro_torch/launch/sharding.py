"""Sharding rules: the model's parameter, optimizer, batch and cache
placements, and the mesh data plane's.

The port of ``repro/launch/sharding.py``.

*The model half* (``param_specs``, ``opt_state_specs``, ``batch_specs``,
``cache_specs_tree``). Strategy: batch over ("pod","data"); TP over
"model" (heads / d_ff / vocab / experts); FSDP (ZeRO-3 style) over
"data" [+"pod"] on each weight's non-TP matrix dim. Rules are regex →
spec-builder over the flattened parameter path. The specs come back in
the reference's tree: the port's per-layer modules (``layers``,
``enc_layers``) are read as one leaf stacked on axis 0, which gets a
leading None, so a spec tree here equals the reference's leaf for leaf.
``P`` stands in for ``jax.sharding.PartitionSpec`` with its equality (a
bare axis name equals its 1-tuple). A mesh is read only for its axis
names and sizes (``mesh_sizes``): a ``DeviceMesh`` with
``mesh_dim_names`` or any stand-in with ``axis_names`` and a ``shape``
mapping.

``placements`` turns a spec into DTensor placements: a spec maps each
tensor dim to mesh axes, a placement each mesh dim to a tensor dim, and
``("pod", "data")`` on one dim shards it over both mesh dims, pod-major,
as JAX splits it. ``to_named`` does so over a spec tree;
``distribute(tree, specs, mesh)`` puts parameters, the AdamW state, a
batch or a cache on the mesh (each rank cuts its shard from the full
tensor it holds, no collective), and ``gather`` brings DTensors back
whole.

*The data-plane half.* The reference states each leaf's
``PartitionSpec`` over the ``("data",)`` axis; on the port's ranks a
leaf is one of:

* ``REPLICATED`` — the same bits on every rank (keys, the global tick,
  telemetry counters, every merged result);
* ``PER_RANK`` — rank ``r``'s row of the reference's ``[N, ...]`` leaf,
  held as ``[1, ...]`` (the sketch state, ``P("data")`` there);
* ``ITEM_SPLIT`` — columns ``[r·M/N, (r+1)·M/N)`` of the item axis of an
  epoch batch (``P(None, "data")`` there).

``CompiledSpmdPipeline.init`` builds the state to this statement, the
checkpoint gathers the ``PER_RANK`` leaves into the reference's layout
and ``spmd_state_shardings`` hands each rank its row back on restore.
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.core.types import IntervalBatch, StratumMeta
from repro_torch.query.compiler import _tree_map


# ------------------------------------------------------------ model half --
def _norm_entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


class P(tuple):
    """``jax.sharding.PartitionSpec``'s stand-in: one entry per tensor
    dim (None, an axis name, or a tuple of names); ``P("data")`` equals
    ``P(("data",))`` as there, and ``P("a")`` differs from
    ``P("a", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            tuple(p) if isinstance(p, list) else p for p in parts))

    def _key(self):
        return tuple(_norm_entry(e) for e in self)

    def __eq__(self, other):
        if not isinstance(other, tuple):
            try:
                other = tuple(other)
            except TypeError:
                return NotImplemented
        return self._key() == tuple(_norm_entry(e) for e in other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names``) or
    of a stand-in with ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axes(mesh):
    names = tuple(mesh_sizes(mesh))
    batch = tuple(a for a in ("pod", "data") if a in names)
    if len(batch) == 1:
        batch = batch[0]
    fsdp = batch  # ZeRO across pods too
    model = "model" if "model" in names else None
    return batch or None, (fsdp or None), model


# rule table: regex on ".../leaf" path → f(batch, fsdp, model) → P(...)
_RULES: list[tuple[str, Any]] = [
    # embeddings / unembedding
    (r"embed/table$",            lambda b, f, m: P(m, f)),
    (r"unembed/w$",              lambda b, f, m: P(f, m)),
    # attention
    (r"attn.*/w[qkv]$",          lambda b, f, m: P(f, m)),
    (r"attn.*/wo$",              lambda b, f, m: P(m, f)),
    (r"(q|k)_norm/scale$",       lambda b, f, m: P()),
    # dense mlp / shared expert
    (r"(mlp|shared)/w_(gate|up)$", lambda b, f, m: P(f, m)),
    (r"(mlp|shared)/w_down$",    lambda b, f, m: P(m, f)),
    (r"mlp/b_up$",               lambda b, f, m: P(m)),
    (r"mlp/b_down$",             lambda b, f, m: P()),
    # MoE experts: EP over model when E divides it, else TP over moe_d_ff
    # (shape-aware — the special case in _spec_for_path)
    (r"moe/router$",             lambda b, f, m: P(f, None)),
    # mamba2
    (r"mamba/w_in$",             lambda b, f, m: P(f, m)),
    (r"mamba/w_out$",            lambda b, f, m: P(m, f)),
    (r"mamba/conv_[wb]$",        lambda b, f, m: P(None, m)),
    (r"mamba/norm_scale$",       lambda b, f, m: P(m)),
    (r"mamba/(a_log|dt_bias|d_skip)$", lambda b, f, m: P()),
    # rwkv6
    (r"tm_cm/w_[rkvg]$",         lambda b, f, m: P(f, m)),
    (r"tm_cm/w_o$",              lambda b, f, m: P(m, f)),
    (r"tm_cm/cm_[kr]$",          lambda b, f, m: P(f, m)),
    (r"tm_cm/cm_v$",             lambda b, f, m: P(m, f)),
    (r"tm_cm/w_lora_a$",         lambda b, f, m: P(f, None)),
    (r"tm_cm/w_lora_b$",         lambda b, f, m: P(None, f)),
    (r"tm_cm/(mu_.|cm_mu|w0|u_bonus|ln_scale|ln_bias)$", lambda b, f, m: P()),
    # norms & anything 1-D
    (r"(ln\d?|ln_x|final_norm|enc_final_norm)/(scale|bias)$",
     lambda b, f, m: P()),
]


def _spec_for_path(path: str, shape: tuple, mesh) -> P:
    ndim = len(shape)
    b, f, m = _axes(mesh)
    n_model = mesh_sizes(mesh).get("model", 1)
    stacked = path.startswith(("layers/", "enc_layers/")) or "/layers/" in path
    if re.search(r"moe/w_(gate|up|down)$", path):
        # stacked leaf: [L, E, d, f] / [L, E, f, d]
        e = shape[1] if stacked else shape[0]
        if m and e % n_model == 0:
            spec = P(m, f, None) if path.endswith(("gate", "up")) else P(m, None, f)
        else:  # EP impossible → replicate experts, TP the ffn dim
            spec = P(None, f, m) if path.endswith(("gate", "up")) else P(None, m, f)
        return P(*(([None] if stacked else []) + list(spec)))
    for pat, fn in _RULES:
        if re.search(pat, path):
            spec = fn(b, f, m)
            break
    else:
        spec = P()
    parts = list(spec)
    # pad/truncate to tensor rank (minus stack dim)
    want = ndim - (1 if stacked else 0)
    parts = (parts + [None] * want)[:want]
    if stacked:
        parts = [None] + parts
    return _validate(P(*parts), shape, mesh)


def _validate(spec: P, shape: tuple, mesh) -> P:
    """Drop axes whose mesh size doesn't divide the dim (odd vocabs:
    whisper 51865, internvl 151655 fall back to replicated on that dim;
    FSDP/TP still applies to the other dims)."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        prod = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            prod *= sizes.get(a, 1)
        out.append(ax if dim % prod == 0 else None)
    return P(*out)


_STACKED = ("layers", "enc_layers")   # per-layer modules, stacked on axis 0


def shape_tree(tree):
    """The reference's tree of leaf shapes: a ``Params`` module (its
    per-layer lists read as one leaf stacked on axis 0), or a mapping of
    tensors or of anything with a ``shape``."""
    if isinstance(tree, nn.Module):
        out = {name: tuple(t.shape) for name, t in tree._parameters.items()}
        for name, sub in tree._modules.items():
            if isinstance(sub, nn.ModuleList):
                per = [shape_tree(m) for m in sub]
                out[name] = _stack_shapes(per)
            else:
                out[name] = shape_tree(sub)
        return out
    if isinstance(tree, Mapping):
        return {k: shape_tree(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _stack_shapes(per: list):
    if isinstance(per[0], Mapping):
        return {k: _stack_shapes([p[k] for p in per]) for k in per[0]}
    return (len(per),) + per[0]


def _map_paths(fn, tree, prefix=""):
    if isinstance(tree, Mapping):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def param_specs(params_shape, mesh):
    """Tree of ``P`` over the parameters (a ``Params`` module or a shape
    tree), in the reference's layout."""
    return _map_paths(lambda path, shape: _spec_for_path(path, shape, mesh),
                      shape_tree(params_shape))


def opt_state_specs(opt_shape, params_spec, mesh):
    """m/v/master shard exactly like their parameter; step replicated."""
    return {"m": params_spec, "v": params_spec, "master": params_spec,
            "step": P()}


def _n_batch(mesh, b) -> int:
    n = 1
    if b:
        sizes = mesh_sizes(mesh)
        for ax in (b if isinstance(b, tuple) else (b,)):
            n *= sizes[ax]
    return n


def batch_specs(batch_shape, mesh):
    """Token batches: batch dim over ("pod","data") when divisible."""
    b, f, m = _axes(mesh)
    n_batch = _n_batch(mesh, b)

    def spec(path, shape):
        if len(shape) == 0:
            return P()
        bdim = shape[0]
        first = b if b and bdim % max(n_batch, 1) == 0 and bdim >= n_batch else None
        rest = [None] * (len(shape) - 1)
        return P(first, *rest)

    return _map_paths(spec, shape_tree(batch_shape))


def cache_specs_tree(cache_shape, mesh):
    """Decode caches: batch over DP axes when divisible, else shard the
    sequence axis (long_500k, B=1); heads over model."""
    b, f, m = _axes(mesh)
    n_batch = _n_batch(mesh, b)
    n_model = mesh_sizes(mesh).get("model", 1)

    def spec(path, shape):
        nd = len(shape)
        if nd == 0:
            return P()
        leaf_name = path.split("/")[-1]
        # layout: [L, B, ...] (stacked caches)
        batch_ok = nd >= 2 and shape[1] % max(n_batch, 1) == 0 and shape[1] >= n_batch
        parts = [None] * nd
        if batch_ok:
            parts[1] = b
        if leaf_name in ("ssm", "wkv"):
            # [L, B, H, N, P] / [L, B, H, k, k]
            if nd == 5 and m and shape[2] % n_model == 0:
                parts[2] = m
        elif leaf_name == "conv":
            if nd == 4 and m and shape[3] % n_model == 0:
                parts[3] = m
        elif leaf_name in ("tm_shift", "cm_shift"):
            if nd == 3 and m and shape[2] % n_model == 0:
                parts[2] = m
        elif nd == 5:
            # attention caches [L, B, Hkv, S, hd]: TP on heads when they
            # divide; otherwise sequence-parallel the cache over "model".
            if m and shape[2] % n_model == 0:
                parts[2] = m
            elif m and shape[3] % n_model == 0:
                parts[3] = m
            if not batch_ok and b and shape[3] % n_batch == 0 and parts[3] is None:
                parts[3] = b           # long-context B=1: SP over DP axes too
        return P(*parts)

    return _map_paths(spec, shape_tree(cache_shape))


# -------------------------------------------------------------- placements --
def placements(spec, mesh, ndim: int | None = None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): for
    each mesh dim, ``Shard(d)`` of the tensor dim whose entry names it,
    else ``Replicate()``. A tuple entry shards its dim over each named
    mesh dim, in the mesh's order (pod-major). ``ndim`` checks the spec
    against the tensor's rank."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    spec = tuple(spec)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {P(*spec)} has more entries than the "
                         f"tensor's {ndim} dims")
    where: dict = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"{P(*spec)}")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def to_named(tree_specs, mesh):
    """A spec tree → the same tree of DTensor placement tuples."""
    if isinstance(tree_specs, Mapping):
        return {k: to_named(v, mesh) for k, v in tree_specs.items()}
    return placements(tree_specs, mesh)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def distribute_tensor(t: torch.Tensor, spec, mesh):
    """``t`` (the full tensor, the same on every rank, or a ``meta``
    tensor) as a DTensor placed by ``spec``; each rank keeps its own
    shard, no collective runs."""
    from torch.distributed.tensor import distribute_tensor as dist_t

    return dist_t(t.detach(), mesh, placements(spec, mesh, t.ndim),
                  src_data_rank=None)


def _distribute_module(mod: nn.Module, specs: Mapping, mesh, drop: int):
    for name, t in list(mod._parameters.items()):
        spec = specs[name]
        spec = P(*tuple(spec)[drop:])
        mod._parameters[name] = nn.Parameter(
            distribute_tensor(t, spec, mesh), requires_grad=False)
    for name, sub in mod._modules.items():
        if isinstance(sub, nn.ModuleList):
            for m in sub:
                _distribute_module(m, specs[name], mesh, drop + 1)
        else:
            _distribute_module(sub, specs[name], mesh, drop)
    return mod


def distribute(tree, specs, mesh):
    """Put ``tree`` on ``mesh`` as ``specs`` (a tree of ``P`` in the
    reference's layout, as the rule functions give it) says: a
    ``Params`` module in place (each per-layer leaf takes its stacked
    spec without the layer dim), a dict leaf by leaf into a new dict, a
    tensor as one DTensor."""
    if isinstance(tree, nn.Module):
        return _distribute_module(tree, specs, mesh, 0)
    if isinstance(tree, Mapping):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, specs, mesh)


def gather_tensor(t):
    """A DTensor's full value as a plain tensor on its rank (a
    collective every rank of its mesh must join); any other tensor as
    it is."""
    if not is_dtensor(t):
        return t
    from repro_torch.launch.mesh import collectives

    with collectives(t.device_mesh):
        return t.full_tensor()


def gather(tree):
    """``tree`` with every DTensor made whole (``gather_tensor``): a
    ``Params`` module becomes a new one of plain tensors."""
    if isinstance(tree, nn.Module):
        from repro_torch.models.layers import Params

        def conv(mod):
            out = {name: gather_tensor(t).detach()
                   for name, t in mod._parameters.items()}
            for name, sub in mod._modules.items():
                out[name] = ([conv(m) for m in sub]
                             if isinstance(sub, nn.ModuleList) else conv(sub))
            return out

        return Params(conv(tree))
    if isinstance(tree, Mapping):
        return {k: gather(v) for k, v in tree.items()}
    return gather_tensor(tree)


REPLICATED = "replicated"
PER_RANK = "per_rank"
ITEM_SPLIT = "item_split"


def spmd_epoch_specs(axis_name: str = "data"):
    """``(inputs, outputs)`` of the stateless epochs (no tenants, or
    ``srs``): the key replicated, the batches split on the item axis
    with their per-tick metadata replicated; ``(sum, mean)``
    replicated."""
    del axis_name
    item = ITEM_SPLIT
    inputs = (REPLICATED, IntervalBatch(item, item, item,
                                        StratumMeta(REPLICATED, REPLICATED)))
    return inputs, (REPLICATED, REPLICATED)


def spmd_query_epoch_specs(axis_name: str, qstate):
    """The tenant lowering's parts: every sketch leaf per rank, the
    batches split on the item axis, everything the root returns
    replicated → ``dict(qstate=..., batches=..., replicated=...)``."""
    del axis_name
    item = ITEM_SPLIT
    return dict(
        qstate=_tree_map(lambda _: PER_RANK, qstate),
        batches=IntervalBatch(item, item, item,
                              StratumMeta(REPLICATED, REPLICATED)),
        replicated=REPLICATED)


class RankShardings(NamedTuple):
    """What ``checkpoint.manager.restore(shardings=)`` needs on a rank:
    the mesh, and a placement per leaf of the target state."""

    mesh: Any
    placements: Any


def spmd_state_shardings(state, mesh) -> RankShardings:
    """Placements of an ``api.spmd.SpmdPipelineState`` (its tick and
    telemetry replicated, its sketch rows per rank) on ``mesh``."""
    parts = spmd_query_epoch_specs(mesh.axis_name, state.qstate)
    return RankShardings(mesh, type(state)(
        tick=REPLICATED, qstate=parts["qstate"],
        telemetry=_tree_map(lambda _: REPLICATED, state.telemetry)))
