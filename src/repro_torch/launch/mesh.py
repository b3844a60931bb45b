"""Meshes: the data mesh (one rank per edge node, collectives in a fixed
order) and the model meshes.

The port of ``repro.launch.mesh`` and of
``repro.launch.analytics.make_data_mesh``.

*Model meshes* are ``torch.distributed.device_mesh.DeviceMesh``es with
``mesh_dim_names`` over the ranks of the current process group, ranks
in row-major order of the mesh's shape:

* ``make_production_mesh(multi_pod=)`` — ``(16, 16)`` over
  ``("data", "model")``, or ``(2, 16, 16)`` with ``"pod"`` in front
  (256 or 512 ranks; the dry run gives them a ``fake`` process group);
* ``make_host_mesh()`` — every rank of the group on one ``("data",)``
  axis;
* ``make_model_mesh(shape, axes, device=, backend=)`` — any shape, on
  the ranks ``spawn_ranks`` starts.

Each raises unless this process is a rank of a group of the mesh's size:
a mesh is never made without its ranks.

*The data mesh.* The reference runs the
§III-E hierarchy in one process over a ``("data",)`` device axis under
``shard_map``; the port runs one process per rank over
``torch.distributed``, every rank calling the same code in the same
order.

* ``DataMesh`` holds a rank's process group, ``rank``, ``size``,
  ``device`` and ``axis_name = "data"``, and the collectives the SPMD
  code calls: ``psum``, ``pmin``, ``pmax``, ``pmean``, ``all_gather``
  and ``axis_index``. Every float sum across ranks is an ``all_gather``
  followed by a left-to-right fold in rank order, so every rank holds
  the same bits on every backend and world size; integer sums and
  min/max use ``all_reduce``. Each collective is written to the mesh's
  ``ledger`` (name, element count and bytes of this rank's operand,
  seconds), so a run can show what crossed the ranks.
* ``make_data_mesh(n, device=, backend=)`` builds a rank's mesh inside
  ``spawn_ranks``; ``n == 1`` outside it is a one-rank mesh with no
  process group.
* ``spawn_ranks(fn, n, ...)`` starts ``n`` rank processes with
  ``torch.multiprocessing`` ``spawn`` (CUDA cannot be forked), joins
  them by a ``file://`` rendezvous in a temporary directory, runs
  ``fn(*args)`` on each and returns every rank's result.

Backends are the caller's choice and never switched: ``nccl`` puts rank
``r`` on ``cuda:r`` (one card a rank); ``gloo`` runs CPU ranks, and also
ranks that share one card (``cuda:0``), staging each collective's
operand to the host and back as a counted copy (``host_copies``). Only
summaries cross, so those copies are small.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

AXIS_NAME = "data"
BACKENDS = ("nccl", "gloo")
_FOLDED = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


class DataMesh:
    """One rank's view of the ``("data",)`` axis (see the module doc)."""

    axis_name = AXIS_NAME

    def __init__(self, *, rank: int, size: int, device: torch.device,
                 backend: str, group=None):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        # (collective, operand elements, operand bytes, seconds) per
        # call, in call order
        self.ledger: list[tuple[str, int, int, float]] = []
        # operands staged through the host (gloo ranks on a card): copies
        # made and bytes moved, both ways
        self.host_copies = 0
        self.host_copy_bytes = 0

    def __repr__(self) -> str:
        return (f"DataMesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r})")

    def axis_index(self) -> int:
        return self.rank

    def reset_ledger(self) -> None:
        self.ledger.clear()
        self.host_copies = 0
        self.host_copy_bytes = 0

    # ------------------------------------------------------------ wiring --
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """The operand where the backend can read it: the host for gloo
        ranks on a card (a counted copy)."""
        if self.backend == "gloo" and x.device.type == "cuda":
            self.host_copies += 1
            self.host_copy_bytes += x.numel() * x.element_size()
            return x.cpu()
        return x.contiguous()

    def _unstage(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.device:
            self.host_copies += 1
            self.host_copy_bytes += x.numel() * x.element_size()
            return x.to(self.device)
        return x

    def _record(self, name: str, x: torch.Tensor, t0: float) -> None:
        self._sync()
        self.ledger.append((name, int(x.numel()),
                            int(x.numel() * x.element_size()),
                            time.perf_counter() - t0))

    def _gather(self, name: str, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x``, in rank order, on this rank's device. The
        device is synchronised before the clock starts, so the ledger's
        seconds are the exchange's, not the producer's."""
        self._sync()
        t0 = time.perf_counter()
        if self.group is None:
            parts = [x]
        else:
            # booleans cross as bytes (gloo has no bool type)
            src = self._stage(x.view(torch.uint8) if x.dtype == torch.bool
                              else x)
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            parts = [self._unstage(p).view(x.dtype) for p in parts]
        self._record(name, x, t0)
        return parts

    def _all_reduce(self, name: str, x: torch.Tensor, op) -> torch.Tensor:
        self._sync()
        t0 = time.perf_counter()
        if self.group is None:
            out = x
        else:
            buf = self._stage(x).clone()
            dist.all_reduce(buf, op=op, group=self.group)
            out = self._unstage(buf)
        self._record(name, x, t0)
        return out

    # ------------------------------------------------------- collectives --
    def all_gather(self, x: torch.Tensor, *, tiled: bool = False
                   ) -> torch.Tensor:
        """``[N, ...]`` stacked in rank order, or with ``tiled=True`` the
        ranks' ``x`` concatenated along axis 0."""
        parts = self._gather("all_gather", x)
        return torch.cat(parts) if tiled else torch.stack(parts)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over ranks. Floats: gathered and added left to right in rank
        order (the same bits on every rank and backend); integers and
        booleans (as int32): one ``all_reduce``."""
        if x.dtype in _FOLDED:
            parts = self._gather("psum", x)
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            return acc
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        return self._all_reduce("psum", x, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce("pmin", x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce("pmax", x, dist.ReduceOp.MAX)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.size

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    # ------------------------------------------------------------ reports --
    def ledger_summary(self) -> dict:
        """Per collective name: calls, largest operand (elements), total
        elements, bytes and seconds."""
        out: dict = {}
        for name, n, nbytes, secs in self.ledger:
            row = out.setdefault(name, {"calls": 0, "max_elems": 0,
                                        "elems": 0, "bytes": 0,
                                        "seconds": 0.0})
            row["calls"] += 1
            row["max_elems"] = max(row["max_elems"], n)
            row["elems"] += n
            row["bytes"] += nbytes
            row["seconds"] += secs
        return out


def rank_device(rank: int, *, device: str, backend: str) -> torch.device:
    """Where rank ``rank`` computes: ``cuda:rank`` under NCCL (one card a
    rank), ``cuda:0`` for gloo ranks sharing a card, else the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         f"'cpu'")
    return torch.device("cuda", rank if backend == "nccl" else 0)


def _check_backend(n: int, device: str, backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown mesh backend {backend!r}; use one of "
                         f"{BACKENDS}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the mesh runs on CUDA devices by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "(backend 'gloo') to run its ranks on the CPU")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend runs one rank per CUDA "
                             "card; use backend='gloo' for CPU ranks")
        have = torch.cuda.device_count()
        if n > have:
            raise RuntimeError(
                f"a {n}-rank nccl mesh needs {n} CUDA devices, and this "
                f"machine has {have}; NCCL refuses two ranks on one card, "
                f"so use backend='gloo' for ranks that share a card")


def make_data_mesh(n_devices: int, *, device: str = "cuda",
                   backend: str) -> DataMesh:
    """This rank's ``DataMesh`` over ``n_devices`` ranks. Inside
    ``spawn_ranks`` it wraps the rank's process group (which must have
    ``n_devices`` ranks and the named backend); outside it only a
    one-rank mesh can be made, and it needs no process group."""
    _check_backend(n_devices, device, backend)
    if not dist.is_initialized():
        if n_devices != 1:
            raise RuntimeError(
                f"a {n_devices}-rank mesh is made inside the rank "
                f"processes that spawn_ranks starts; this process is not "
                f"one of them")
        return DataMesh(rank=0, size=1, backend=backend,
                        device=rank_device(0, device=device,
                                           backend=backend))
    size, rank = dist.get_world_size(), dist.get_rank()
    if size != n_devices:
        raise RuntimeError(f"this rank's process group has {size} ranks, "
                           f"not {n_devices}")
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(f"this rank's process group runs {have!r}, not "
                           f"{backend!r}")
    return DataMesh(rank=rank, size=size, backend=backend,
                    group=dist.group.WORLD,
                    device=rank_device(rank, device=device, backend=backend))


def _world_mesh(shape: tuple, axes: tuple, device_type: str):
    import math

    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} model mesh needs {n} ranks: "
            f"make it inside the rank processes that spawn_ranks starts "
            f"(or, for the dry run, a fake process group of {n} ranks); "
            f"this process is not one of them")
    if dist.get_world_size() != n:
        raise RuntimeError(f"this rank's process group has "
                           f"{dist.get_world_size()} ranks, and a "
                           f"{'x'.join(map(str, shape))} mesh needs {n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` with
    ``"pod"`` in front, over this process group's 256 or 512 ranks; the
    mesh's device type is the one of the group's backend (``cpu`` for
    ``gloo`` and ``fake``, ``cuda`` for ``nccl``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _world_mesh(shape, axes, _group_device_type())


def make_host_mesh():
    """Every rank of this process group on one ``("data",)`` axis."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group; make the "
                           "mesh inside the ranks that spawn_ranks starts")
    return _world_mesh((dist.get_world_size(),), ("data",),
                       _group_device_type())


def _group_device_type() -> str:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def make_model_mesh(shape, axes, *, device: str = "cuda", backend: str):
    """This rank's ``DeviceMesh`` of ``shape`` over ``axes`` inside
    ``spawn_ranks``: ``nccl`` ranks one card each, ``gloo`` ranks on the
    CPU or sharing ``cuda:0``. The group must have ``prod(shape)`` ranks
    and the named backend."""
    import math

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    _check_backend(math.prod(shape), device, backend)
    if dist.is_initialized() and dist.get_backend() != backend:
        raise RuntimeError(f"this rank's process group runs "
                           f"{dist.get_backend()!r}, not {backend!r}")
    return _world_mesh(shape, axes, torch.device(device).type)


def _rank_main(rank, n, fn, args, device, backend, timeout_s, init_file,
               out_dir):
    """One rank: join the group, run ``fn(*args)``, pickle its result."""
    dev = rank_device(rank, device=device, backend=backend)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n: int, *, args=(), device: str = "cuda",
                backend: str, timeout_s: float = 300.0) -> list:
    """Run ``fn(*args)`` on ``n`` rank processes and return their results
    in rank order. ``fn`` must be importable (a module-level function);
    inside it ``make_data_mesh(n, device=device, backend=backend)`` gives
    the rank its mesh. The kernels are built here once, before any rank
    starts. A rank that raises fails the call (the other ranks are
    stopped and the error is raised here); so does a run that outlasts
    ``timeout_s``, the bound also given to every collective."""
    import torch.multiprocessing as mp

    _check_backend(n, device, backend)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    with tempfile.TemporaryDirectory(prefix="repro_mesh_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, nprocs=n, join=False, start_method="spawn",
            args=(n, fn, tuple(args), device, backend, timeout_s, init_file,
                  tmp))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} mesh ranks did not finish "
                                       f"within {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


# ------------------------------------------------- model mesh collectives --
_FUNCOL = ("_c10d_functional", "c10d_functional")
_NOT_COLLECTIVE = ("wait_tensor", "_wrap_tensor_autograd")


class ModelMeshLedger:
    """The collectives a model mesh's DTensors issue on this rank, by
    kind: calls, operand bytes, and seconds from the operand's readiness
    to the result's (the device synchronised on each side); and, for
    gloo ranks on a card, the operand and result copies staged through
    the host."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls: dict[str, dict] = {}
        self.host_copies = 0
        self.host_copy_bytes = 0

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        row = self.calls.setdefault(kind, {"calls": 0, "bytes": 0,
                                           "seconds": 0.0})
        row["calls"] += 1
        row["bytes"] += nbytes
        row["seconds"] += seconds

    def totals(self) -> dict:
        return {"calls": sum(r["calls"] for r in self.calls.values()),
                "bytes": sum(r["bytes"] for r in self.calls.values()),
                "seconds": sum(r["seconds"] for r in self.calls.values()),
                "host_copies": self.host_copies,
                "host_copy_bytes": self.host_copy_bytes}


def _collectives_mode(ledger: ModelMeshLedger, stage: bool):
    """A dispatch mode over DTensor's collectives (the
    ``_c10d_functional`` operations it issues on local tensors): each is
    timed into ``ledger`` and, with ``stage``, run on host copies of its
    CUDA operands, the result copied back (gloo ranks sharing a card)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves, tree_map

    class Collectives(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            leaves = tree_leaves((args, kwargs))
            if any(isinstance(t, DTensor) for t in leaves):
                return NotImplemented   # its local operations come back
            name = func._schema.name.split("::")[-1]
            if func.namespace not in _FUNCOL or name in _NOT_COLLECTIVE:
                return func(*args, **kwargs)
            tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
            cuda = [t for t in tensors if t.device.type == "cuda"]
            dev = cuda[0].device if cuda else None
            if dev is not None:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if stage and dev is not None:
                def host(t):
                    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                        ledger.host_copies += 1
                        ledger.host_copy_bytes += t.numel() * t.element_size()
                        return t.cpu()
                    return t

                out = func(*tree_map(host, args), **tree_map(host, kwargs))
                out = tree_map(lambda t: torch.ops._c10d_functional
                               .wait_tensor(t) if isinstance(
                                   t, torch.Tensor) else t, out)

                def back(t):
                    if isinstance(t, torch.Tensor):
                        ledger.host_copies += 1
                        ledger.host_copy_bytes += t.numel() * t.element_size()
                        return t.to(dev)
                    return t

                out = tree_map(back, out)
                if name.endswith("_"):          # in place: into the operand
                    args[0].copy_(out)
                    out = args[0]
            else:
                out = func(*args, **kwargs)
                out = tree_map(lambda t: torch.ops._c10d_functional
                               .wait_tensor(t) if isinstance(
                                   t, torch.Tensor) else t, out)
            if dev is not None:
                torch.cuda.synchronize(dev)
            src = tensors[:1]
            ledger.add(name, sum(t.numel() * t.element_size() for t in src),
                       time.perf_counter() - t0)
            return out

    return Collectives()


def model_mesh_ledger(mesh) -> ModelMeshLedger | None:
    """The ledger that ``use_mesh`` keeps for a ``DeviceMesh`` (made on
    first use), or None for a rule stand-in."""
    if not hasattr(mesh, "mesh_dim_names"):
        return None
    ledger = getattr(mesh, "_repro_ledger", None)
    if ledger is None:
        ledger = ModelMeshLedger()
        mesh._repro_ledger = ledger
    return ledger


def collectives(mesh):
    """The context ``use_mesh`` and ``sharding.gather`` run a model mesh
    in: DTensor's collectives counted into ``model_mesh_ledger(mesh)``,
    and staged through the host when the mesh's ranks are gloo ranks on
    a card (gloo's own CUDA collectives are not relied on; no step
    moves to the CPU)."""
    ledger = model_mesh_ledger(mesh)
    if ledger is None or not dist.is_initialized() \
            or dist.get_backend() == "fake":
        import contextlib

        return contextlib.nullcontext()
    stage = mesh.device_type == "cuda" and dist.get_backend() == "gloo"
    return _collectives_mode(ledger, stage)
