"""Cost model over the operations one step dispatches, per rank.

The port of ``repro/launch/hlocost.py``. The reference parses the
partitioned HLO text of a compiled step (there is no HLO here, and no
counterpart of its parser); the port counts what the step dispatches.
``OpCost`` is a ``TorchDispatchMode``: an operation on DTensors passes
through it to DTensor's own dispatch, so what it counts is the plain
operations each rank runs on its local shards, and the collectives that
DTensor issues between them. All totals are per rank (per chip), as the
reference's partitioned shapes are per device.

* FLOPs: matrix products (``mm``, ``bmm``, ``addmm``, convolutions,
  ...) by ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry), 2·M·N·K each, counted also as ``dot_flops``; a pointwise
  operation one FLOP per result element; a reduction one per input
  element (the reference's ``elementwise = numel``, ``reduce =
  numel(operand)``); data movement none.
* Bytes: operands plus results of every operation that moves data (a
  view moves none), the reference's "bytes accessed".
* Collectives: the ``_c10d_functional`` operations by kind, with the
  reference's names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``), each with its count and this
  rank's operand bytes. (``CommDebugMode`` counts the same operations;
  it keeps no bytes.)

DTensor's own planning is not the step's work: on a cache miss its
redistribution planner and its shard-size helpers compute sizes and
offsets with ``arange``/``split``/``cat`` on host tensors, so counting
them would make a cell's totals depend on what ran before it in the
process. An operation none of whose tensors is on the device of the
step's DTensors is that planning, and counts nothing; nor does one that
makes or takes FakeTensors (DTensor's shape propagation).

``zero_s2_seq`` reprices the attention scores as a flash kernel keeps
them: a tensor whose last dim is S and second-to-last at least S/64
moves no bytes. Runs on ``meta`` tensors count shapes and nothing else:
the dry run computes nothing.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.sharding import is_dtensor

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_FUNCOL = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "std", "var_mean", "cumsum", "cumprod", "logsumexp", "norm",
               "_softmax", "_log_softmax", "any", "all", "argmax", "argmin",
               "sort", "topk", "linalg_vector_norm", "nansum"}
_FREE = {"detach", "alias", "lift_fresh", "_local_scalar_dense", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "sym_size", "sym_stride", "sym_numel", "is_same_size", "set_"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class OpCost(TorchDispatchMode):
    """Counts FLOPs, matmul FLOPs, bytes and collectives of what runs in
    its block (see the module doc); ``totals()`` reads them."""

    def __init__(self, zero_s2_seq: int | None = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.zero_s2_seq = zero_s2_seq
        self._flop_fns = flop_registry
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.collectives: dict[str, dict] = {}
        self._step_device = None     # the device of the DTensors seen

    def _nbytes(self, t: torch.Tensor) -> float:
        s2 = self.zero_s2_seq
        shape = tuple(t.shape)
        if (s2 and len(shape) >= 2 and shape[-1] == s2
                and shape[-2] >= max(s2 // 64, 2)):
            return 0.0
        return float(t.numel() * t.element_size())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = tree_leaves((args, kwargs))
        dts = [t for t in leaves if is_dtensor(t)]
        if dts:
            # DTensor dispatches it; its local operations and the
            # collectives it issues come back through this mode.
            self._step_device = dts[0].device
            return NotImplemented
        if any(isinstance(t, FakeTensor) for t in leaves):
            # DTensor's sharding propagation trying the operation on
            # global shapes: nothing runs
            return func(*args, **kwargs)
        # a composite operation (matmul, einsum under inference mode)
        # counts as the operations it decomposes into, as under autograd
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        if not self._planning(leaves, out):
            self._count(func, args, kwargs, out)
        return out

    def _planning(self, leaves, out) -> bool:
        """Whether an operation is DTensor's planning rather than the
        step's: it makes FakeTensors, or none of its tensors lies on the
        device of the step's DTensors."""
        ts = _tensors(out) + [t for t in leaves
                              if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ts):
            return True
        dev = self._step_device
        return dev is not None and all(t.device != dev for t in ts)

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in _FUNCOL:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                src = _tensors(args[:1])
                rec = self.collectives.setdefault(kind,
                                                  {"count": 0.0, "bytes": 0.0})
                rec["count"] += 1
                rec["bytes"] += sum(float(t.numel() * t.element_size())
                                    for t in src)
            return
        if name in _FREE or func.is_view:
            return
        outs = _tensors(out)
        packet = func.overloadpacket
        if packet in self._flop_fns:
            f = float(self._flop_fns[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.dot_flops += f
        elif torch.Tag.pointwise in func.tags:
            self.flops += float(sum(t.numel() for t in outs))
        elif name in _REDUCTIONS:
            ins = _tensors(args[:1])
            self.flops += float(sum(t.numel() for t in ins))
        self.bytes += sum(self._nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(self._nbytes(t) for t in outs)

    def totals(self) -> dict:
        """The reference's ``analyze_text`` record: ``flops``,
        ``dot_flops``, ``bytes``, ``collectives`` (by kind: count,
        bytes) and ``collective_bytes``; per rank."""
        return {
            "flops": self.flops, "dot_flops": self.dot_flops,
            "bytes": self.bytes,
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "collective_bytes": sum(v["bytes"]
                                    for v in self.collectives.values()),
        }


def analyze(fn, *args, zero_s2_seq: int | None = None, **kwargs):
    """``(fn(*args, **kwargs), totals)``: one call counted by
    ``OpCost``."""
    with OpCost(zero_s2_seq=zero_s2_seq) as cost:
        out = fn(*args, **kwargs)
    return out, cost.totals()
