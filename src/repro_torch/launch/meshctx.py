"""Mesh context: logical-axis sharding constraints that degrade gracefully.

The port of ``repro/launch/meshctx.py``. Model code annotates
activations with *logical* axes ("batch", "model", "seq", ...). Under
``use_mesh(mesh)`` they resolve to physical mesh axes, and ``shard``
redistributes a DTensor to them; without a mesh, or on a plain tensor,
``shard`` is the identity. Batch maps to ``("pod", "data")`` when a pod
axis exists, so the same model code serves both production meshes.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, or any object with ``axis_names`` and a ``shape``
mapping names to sizes (the rule tables read nothing else, so a stand-in
of names and sizes is enough for them). Under a ``DeviceMesh`` the block
also enters DTensor's implicit replication: a plain tensor that meets a
DTensor (positions, masks, constants made inside the model) counts as
replicated on every rank; and DTensor's collectives go through
``launch.mesh.collectives`` (counted into the mesh's ledger, and staged
through the host for gloo ranks on a card).
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.launch.sharding import P, mesh_sizes, placements

_state = threading.local()

# logical name -> candidate physical axes, first present in the mesh win(s).
_LOGICAL = {
    "batch": ("pod", "data"),       # all present axes combined
    "fsdp": ("data",),              # weight-shard axis
    "fsdp_pod": ("pod", "data"),    # weight-shard incl. pod (ZeRO across pods)
    "model": ("model",),
    "expert": ("model",),
    None: (),
}


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` for the model code run in the block (this thread
    only)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        if hasattr(mesh, "mesh_dim_names"):
            from torch.distributed.tensor.experimental import \
                implicit_replication

            from repro_torch.launch.mesh import collectives

            with implicit_replication(), collectives(mesh):
                yield mesh
        else:
            yield mesh
    finally:
        _state.mesh = prev


def resolve_spec(*logical: str | None) -> P:
    """Translate logical axis names into a ``P`` for the current mesh."""
    mesh = current_mesh()
    names = set(mesh_sizes(mesh)) if mesh is not None else set()
    out = []
    for ax in logical:
        if ax is None:
            out.append(None)
            continue
        phys = tuple(a for a in _LOGICAL.get(ax, (ax,)) if a in names)
        if not phys:
            out.append(None)
        elif len(phys) == 1:
            out.append(phys[0])
        else:
            out.append(phys)
    return P(*out)


def shard(x, *logical: str | None):
    """Redistribute a DTensor to the logical axes (and its gradient, on
    the way back, to the same); the identity without a ``DeviceMesh``
    installed or on a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not hasattr(mesh, "mesh_dim_names"):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    # redistributed even when already so placed: as a sharding constraint
    # does, it also places the gradient that flows back through it
    return x.redistribute(x.device_mesh,
                          placements(resolve_spec(*logical), mesh,
                                     ndim=x.ndim))
