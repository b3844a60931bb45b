"""Checkpointing: atomic, keep-N, the reference's on-disk format.

The port's own copy of ``repro.checkpoint.manager``. One directory per
step:

    <root>/step_000000123.tmp/  → written, then renamed to
    <root>/step_000000123/
        manifest.json         step, treedef, num_leaves, meta, leaves
        arr_00000.npy ...     one file per leaf, in flatten order

Leaves are saved as full host arrays (a bf16 tensor as the f32 array of
its values, which ``restore`` casts back; a DTensor of a model mesh is
gathered whole first, a collective all its ranks join). The flatten order is the one
``jax.tree_util.tree_flatten`` gives the reference's pytrees: NamedTuple
fields in declaration order, tuples and lists in order, dicts by sorted
key, ``()`` and ``None`` no leaf, every tensor or array one leaf. The
reference's ``restore`` checks only the leaf count and each leaf's
shape, so a checkpoint of a ``PipelineState`` written here restores in
the reference and the other way round. ``treedef`` is this module's own
description of the structure (the reference writes its ``PyTreeDef``);
neither package reads it back.

Fault tolerance: a crash mid-write leaves only ``*.tmp``, which
``latest_step`` ignores; ``keep_n`` prunes old steps only after a
successful rename.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, (np.ndarray, np.generic,
                                                int, float, bool))


def _flatten(tree) -> list:
    """The leaves of ``tree`` in the reference's flatten order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for part in tree for x in _flatten(part)]
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")


def _flatten_like(spec, tree) -> list:
    """``spec``'s nodes at the leaf positions of ``tree`` (a pytree of
    per-leaf placements laid over the tree they describe)."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [spec]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_like(spec[k],
                                                               tree[k])]
    return [x for s, t in zip(spec, tree) for x in _flatten_like(s, t)]


def _describe(tree) -> str:
    """A readable description of the structure (``*`` a leaf)."""
    if tree is None:
        return "None"
    if _is_leaf(tree):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if hasattr(tree, "_fields"):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{f}={_describe(v)}"
                            for f, v in zip(tree._fields, tree)) + ")")
    body = ", ".join(_describe(x) for x in tree)
    return f"[{body}]" if isinstance(tree, list) else f"({body})"


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        # a model mesh's DTensor is saved whole (every rank gathers it)
        from repro_torch.launch.sharding import gather_tensor

        leaf = gather_tensor(leaf.detach()).cpu()
        if leaf.dtype == torch.bfloat16:   # numpy has no bf16: exact in f32
            leaf = leaf.to(torch.float32)
        return leaf.numpy()
    return np.asarray(leaf)


def _load(path: pathlib.Path) -> np.ndarray:
    """One leaf file. A bf16 leaf the reference wrote (ml_dtypes'
    ``bfloat16``, 2-byte records to a numpy without it) comes back as
    the f32 array of the same values."""
    arr = np.load(path)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    return arr


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves`` (host arrays), each cast to its template leaf's
    dtype and put on its device."""
    if template is None:
        return None
    if torch.is_tensor(template):
        return torch.as_tensor(next(leaves), dtype=template.dtype,
                               device=template.device)
    if _is_leaf(template):
        return np.asarray(next(leaves), dtype=np.asarray(template).dtype)
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    parts = [_unflatten(x, leaves) for x in template]
    if hasattr(template, "_fields"):
        return type(template)(*parts)
    return type(template)(parts)


def save(root: str | pathlib.Path, step: int, tree, *, meta: dict | None = None,
         keep_n: int = 3) -> pathlib.Path:
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:09d}"
    tmp = root / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves = _flatten(tree)
    manifest = {
        "step": step,
        "treedef": _describe(tree),
        "num_leaves": len(leaves),
        "meta": meta or {},
        "written_at": time.time(),
        "leaves": [],
    }
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        np.save(tmp / f"arr_{i:05d}.npy", arr)
        manifest["leaves"].append({"shape": list(arr.shape),
                                   "dtype": str(arr.dtype)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)

    if keep_n:
        steps = sorted(p for p in root.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        for old in steps[:-keep_n]:
            shutil.rmtree(old)
    return final


def latest_step(root: str | pathlib.Path) -> int | None:
    root = pathlib.Path(root)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def read_manifest(root: str | pathlib.Path, step: int) -> dict:
    """A step's manifest, read without loading any leaf: callers (for
    example ``api.pipeline.restore_state``) check its metadata before
    the leaf-by-leaf restore, so a mismatched checkpoint fails with an
    actionable error instead of a shape mismatch."""
    path = pathlib.Path(root) / f"step_{step:09d}"
    return json.loads((path / "manifest.json").read_text())


def restore(root: str | pathlib.Path, step: int, target_tree, *,
            shardings=None):
    """Load into the structure of ``target_tree`` (shape and dtype
    template; each leaf lands on its template leaf's device) →
    ``(tree, meta)``.

    ``shardings`` re-meshes on load: a ``launch.sharding.RankShardings``
    (a rank's mesh and a placement per leaf of ``target_tree``, from
    ``spmd_state_shardings``). A ``PER_RANK`` leaf is stored in the
    reference's ``[N, ...]`` layout and the rank loads its own row as
    ``[1, ...]``; a replicated leaf loads whole."""
    path = pathlib.Path(root) / f"step_{step:09d}"
    manifest = json.loads((path / "manifest.json").read_text())
    leaves = _flatten(target_tree)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(f"leaf count mismatch: ckpt "
                         f"{manifest['num_leaves']} vs target {len(leaves)}")
    rows = [None] * len(leaves)
    if shardings is not None:
        from repro_torch.launch.sharding import PER_RANK

        mesh = shardings.mesh
        rows = [(mesh.rank, mesh.size) if p == PER_RANK else None
                for p in _flatten_like(shardings.placements, target_tree)]
    arrays = []
    for i, (tmpl, row) in enumerate(zip(leaves, rows)):
        arr = _load(path / f"arr_{i:05d}.npy")
        if row is not None:
            rank, size = row
            if arr.shape[:1] != (size,):
                raise ValueError(f"leaf {i} holds {arr.shape[:1]} rows, "
                                 f"not one per rank of a {size}-rank mesh")
            arr = arr[rank:rank + 1]
        if tuple(arr.shape) != tuple(np.shape(tmpl)):
            raise ValueError(f"leaf {i} shape mismatch: ckpt "
                             f"{tuple(arr.shape)} vs target "
                             f"{tuple(np.shape(tmpl))}")
        arrays.append(arr)
    return _unflatten(target_tree, iter(arrays)), manifest["meta"]


class AsyncCheckpointer:
    """Overlap checkpoint writes with the caller's work (one in flight).
    The leaves are copied to the host on the calling thread, so the
    caller may hand the state on (for example to ``run_epoch``, which
    consumes it) as soon as ``save`` returns."""

    def __init__(self, root: str | pathlib.Path, keep_n: int = 3):
        self.root = root
        self.keep_n = keep_n
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree, meta: dict | None = None) -> None:
        self.wait()
        host_tree = _unflatten_host(tree)
        self._thread = threading.Thread(
            target=save, args=(self.root, step, host_tree),
            kwargs=dict(meta=meta, keep_n=self.keep_n), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _unflatten_host(tree):
    """``tree`` with every leaf copied to a host array (a copy, also of a
    CPU tensor, whose buffer the caller may go on to overwrite)."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return np.array(_host(tree), copy=True)
    if isinstance(tree, dict):
        return {k: _unflatten_host(v) for k, v in tree.items()}
    parts = [_unflatten_host(x) for x in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*parts)
    return type(tree)(parts)
