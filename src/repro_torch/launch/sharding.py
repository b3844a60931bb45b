"""Placements of the mesh data plane's state and batches.

The counterpart of the data-plane half of ``repro.launch.sharding``
(``spmd_epoch_specs``, ``spmd_query_epoch_specs``). The reference
states each leaf's ``PartitionSpec`` over the ``("data",)`` axis; on
the port's ranks a leaf is one of:

* ``REPLICATED`` — the same bits on every rank (keys, the global tick,
  telemetry counters, every merged result);
* ``PER_RANK`` — rank ``r``'s row of the reference's ``[N, ...]`` leaf,
  held as ``[1, ...]`` (the sketch state, ``P("data")`` there);
* ``ITEM_SPLIT`` — columns ``[r·M/N, (r+1)·M/N)`` of the item axis of an
  epoch batch (``P(None, "data")`` there).

``CompiledSpmdPipeline.init`` builds the state to this statement, the
checkpoint gathers the ``PER_RANK`` leaves into the reference's layout
and ``spmd_state_shardings`` hands each rank its row back on restore.
The model-sharding rules of the reference's module go with training
(ROADMAP Queue 1 item 12b).
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core.types import IntervalBatch, StratumMeta
from repro_torch.query.compiler import _tree_map

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
