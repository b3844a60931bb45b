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
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.api.pipeline import PipelineState
from repro_torch.core.window import TreeState
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
