"""Carry pipeline state between the reference and the port.

The system has no weights: what crosses over is the state, the whole
hierarchy's buffers, the tenants' sketch state (``qstate``) and the tick
counter. ``state_from_numpy`` takes a reference ``PipelineState`` whose
leaves are numpy arrays (for example
``jax.tree.map(np.asarray, state)``; any object or mapping with the
reference's field names works) and builds the port's ``PipelineState``
on a device. ``state_to_numpy`` goes the other way, to nested dicts of
numpy arrays under the same names. ``qstate`` keeps the reference's
layout: one ``(mask, sketches)`` pair per slot group, each sketch a
quantile, windowed-quantile or heavy-hitter state (told apart by its
field names) or ``()`` for a stateless query.

The model zoo's weights cross the same way: ``params_from_numpy`` takes
the reference's parameter tree (nested dicts of numpy arrays, the
decoder's and the encoder's layers stacked on axis 0) and builds the
port's ``Params`` module with one entry per layer; ``params_to_numpy``
stacks them back. ``cache_from_numpy`` and ``cache_to_numpy`` carry
``init_cache``'s dict of every family, ``opt_state_from_numpy`` and
``opt_state_to_numpy`` the AdamW state. Going to numpy, a DTensor of a
model mesh is gathered whole (``launch.sharding.gather``), so every
rank of the mesh must make the same call. Every leaf takes the
reference's dtype: the model's, but f32 for the leaves the reference
keeps in f32 in a bf16 model. bf16 arrays (numpy's ``bfloat16`` from
the reference) come in bit for bit and go out as f32, which holds every
bf16 value exactly.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.api.pipeline import PipelineState
from repro_torch.core.window import TreeState
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.layers import Params
from repro_torch.obs.telemetry import EpochTelemetry
from repro_torch.query.sketches import (HeavyHitterSketch, QuantileSketch,
                                        WindowedQuantileSketch)

_DTYPES = {"values": torch.float32, "strata": torch.int32,
           "fill": torch.int32, "dropped": torch.int32,
           "w_in": torch.float32, "c_in": torch.float32,
           "wc_acc": torch.float32, "c_acc": torch.float32,
           "seen": torch.bool}


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _is_empty(leaf) -> bool:
    return isinstance(leaf, (tuple, list)) and len(leaf) == 0


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.array(a), dtype=dtype, device=device)


_SKETCHES = {frozenset(cls._fields): cls for cls in
             (QuantileSketch, WindowedQuantileSketch, HeavyHitterSketch)}
_INT_FIELDS = ("key", "head")


def _fields(leaf) -> tuple:
    return tuple(leaf) if isinstance(leaf, Mapping) else leaf._fields


def _qstate_from(qstate, device) -> tuple:
    def sketch(leaf):
        if _is_empty(leaf):
            return ()
        cls = _SKETCHES[frozenset(_fields(leaf))]
        return cls(**{f: _tensor(_get(leaf, f), torch.int32
                                 if f in _INT_FIELDS else torch.float32,
                                 device) for f in cls._fields})

    return tuple((_tensor(mask, torch.bool, device),
                  tuple(sketch(leaf) for leaf in states))
                 for mask, states in qstate)


def _qstate_to(qstate) -> tuple:
    def host(t):
        return t.detach().cpu().numpy()

    return tuple((host(mask), tuple(
        {f: host(v) for f, v in zip(leaf._fields, leaf)} if leaf else ()
        for leaf in states)) for mask, states in qstate)


def state_from_numpy(state, device="cpu") -> PipelineState:
    """The reference's ``PipelineState`` (numpy leaves) → the port's."""
    tree = _get(state, "tree")
    fields = {f: tuple(_tensor(a, _DTYPES[f], device) for a in _get(tree, f))
              for f in TreeState.LEVEL_FIELDS}
    tel = _get(tree, "telemetry")
    if not _is_empty(tel):
        tel = EpochTelemetry(*(
            _tensor(_get(tel, f), torch.int32 if np.asarray(
                _get(tel, f)).dtype.kind in "iu" else torch.float32, device)
            for f in EpochTelemetry._fields))
    else:
        tel = ()
    route = _get(tree, "route")
    route = () if _is_empty(route) else _tensor(route, torch.int32, device)
    return PipelineState(
        tree=TreeState(**fields,
                       qstate=_qstate_from(_get(tree, "qstate"), device),
                       telemetry=tel, route=route),
        tick=_tensor(_get(state, "tick"), torch.int32, device))


def state_to_numpy(state: PipelineState) -> dict:
    """The port's ``PipelineState`` → ``{"tree": {...}, "tick": ...}``
    with numpy leaves under the reference's field names."""
    def host(t):
        return t.detach().cpu().numpy()

    tree = state.tree
    out = {f: tuple(host(a) for a in getattr(tree, f))
           for f in TreeState.LEVEL_FIELDS}
    out["qstate"] = _qstate_to(tree.qstate)
    out["telemetry"] = (
        {f: host(v) for f, v in zip(EpochTelemetry._fields, tree.telemetry)}
        if isinstance(tree.telemetry, EpochTelemetry) else ())
    out["route"] = () if isinstance(tree.route, tuple) else host(tree.route)
    return {"tree": out, "tick": host(state.tick)}


# ------------------------------------------------------------- the models --
def _weight(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # the reference's bf16: same bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def _host_weight(t: torch.Tensor) -> np.ndarray:
    from repro_torch.launch.sharding import gather_tensor

    t = gather_tensor(t.detach()).cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


_STACKED = ("layers", "enc_layers")   # stacked on axis 0 in the reference


def _module_from(tree: Mapping, dtype_of, dev) -> Params:
    """A reference tree of numpy arrays → a ``Params`` module on ``dev``,
    each leaf in ``dtype_of(its name)``; a ``_STACKED`` subtree becomes
    a list of per-layer modules."""
    def conv(node, name, index=None):
        if isinstance(node, Mapping):
            return {k: conv(v, k, index) for k, v in node.items()}
        a = node if index is None else np.asarray(node)[index]
        return _weight(a, dtype_of(name), dev)

    def depth(node):
        return depth(next(iter(node.values()))) if isinstance(
            node, Mapping) else np.shape(node)[0]

    return Params({k: [conv(v, k, i) for i in range(depth(v))]
                   if k in _STACKED else conv(v, k)
                   for k, v in tree.items()})


def _param_dtype(cfg):
    return lambda name: (torch.float32 if name in M.F32_LEAVES
                         else cfg.param_dtype)


def params_from_numpy(cfg, tree: Mapping, device="cuda") -> Params:
    """The reference's parameter tree → the port's ``Params`` on
    ``device``, every leaf in the reference's dtype: ``cfg.param_dtype``
    but for the leaves the reference keeps in f32 (``model.F32_LEAVES``).
    ``tree["layers"]`` and ``tree["enc_layers"]`` (stacked on axis 0)
    become lists of per-layer modules; the hybrid's ``shared_attn`` is
    one module."""
    return _module_from(tree, _param_dtype(cfg), resolve_device(device))


def params_to_numpy(params: Params) -> dict:
    """The port's ``Params`` → the reference's tree of numpy arrays, the
    layers stacked on axis 0."""
    def conv(mod):
        out = {name: _host_weight(t) for name, t in mod._parameters.items()}
        for name, sub in mod._modules.items():
            if isinstance(sub, torch.nn.ModuleList):
                per = [conv(m) for m in sub]
                out[name] = _stack(per)
            else:
                out[name] = conv(sub)
        return out

    def _stack(per):
        if isinstance(per[0], Mapping):
            return {k: _stack([p[k] for p in per]) for k in per[0]}
        return np.stack(per)

    return conv(params)


def cache_from_numpy(cfg, cache: Mapping, device="cuda") -> dict:
    """``init_cache``'s dict of numpy arrays (any family) → tensors on
    ``device`` in the reference's dtypes: ``cfg.param_dtype`` but the f32
    state (``model.F32_CACHE``: the hybrid's ``ssm``, the ssm family's
    ``wkv``)."""
    dev = resolve_device(device)
    return {k: _weight(v, torch.float32 if k in M.F32_CACHE
                       else cfg.param_dtype, dev) for k, v in cache.items()}


def cache_to_numpy(cache: Mapping) -> dict:
    return {k: _host_weight(v) for k, v in cache.items()}


def opt_state_from_numpy(state: Mapping, device="cuda") -> dict:
    """The reference's AdamW state (``m``, ``v`` and ``master``, f32
    trees shaped like the parameters, and ``step``) → the port's
    (``optim.adamw.init``'s layout: three f32 ``Params`` modules and an
    int32 scalar)."""
    dev = resolve_device(device)
    out = {k: _module_from(state[k], lambda name: torch.float32, dev)
           for k in ("m", "v", "master")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=dev)
    return out


def opt_state_to_numpy(state: Mapping) -> dict:
    out = {k: params_to_numpy(state[k]) for k in ("m", "v", "master")}
    out["step"] = np.asarray(_host_weight(state["step"]).item(), np.int32)
    return out
