"""``compile(spec, mesh=...)``: the same spec on the mesh data plane.

The counterpart of ``repro.api.spmd``. The reference lowers a spec onto
a ``("data",)`` device axis under ``shard_map``, one process driving
every device; the port runs one process per rank (``launch.mesh``), each
holding a ``DataMesh`` and calling ``compile``, ``init``, ``run_epoch``,
``admit``, ``retire`` and the checkpoint functions in the same order as
every other rank. Three lowerings share the front door:

* **Tenants registered** (the multi-tenant query plane): every rank
  samples its shard of each window with its own sketch state, and the
  window is answered from summaries merged across the ranks — summed CLT
  moments and histogram bins, gathered quantile buffers and count-min
  tables (``query.compiler.CompiledQueryPlan.evaluate_spmd``). No item
  crosses a rank. The applied sample budget is an input of every epoch;
  the state (global tick, this rank's sketch rows) is explicit, so
  epochs resume bitwise as one long epoch.
* **``whs`` without tenants** (the §III-E two-level path): every rank
  samples and compacts its shard, the compacted reservoirs are gathered,
  and the root stage samples them again and answers SUM/MEAN with bounds
  (``core.tree.spmd_local_then_root_epoch``). Stateless.
* **``srs``** (the §IV-B baseline): coin-flip keeps on every rank, HT
  SUM and sample MEAN from summed moments.

``run_epoch`` takes the whole epoch batch (``value[T, M]``); rank ``r``
takes columns ``[r·M/N, (r+1)·M/N)``. Results come back the same bits on
every rank: every float sum across ranks is a gather folded in rank
order (``DataMesh.psum``).

State layout: the tick and the telemetry counters are replicated; each
leaf of ``qstate`` is this rank's row with a leading axis of 1 (the
reference's ``[N, ...]`` leaves, row ``r``), so the churn transforms run
with ``slot_axis=1``, and a checkpoint gathers the rows into the
reference's layout (``api.pipeline.save_state``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.api import spec as specmod
from repro_torch.api.pipeline import QueryRouting, WindowAnswers
from repro_torch.api.spec import PipelineSpec, SpecError
from repro_torch.core import prng
from repro_torch.core import tree as T
from repro_torch.core.types import IntervalBatch, StratumMeta
from repro_torch.query.compiler import _tree_map


class SpmdPipelineState(NamedTuple):
    """The tenant lowering's state on one rank: the next global tick
    (i32 scalar, replicated), this rank's sketch rows (every leaf
    ``[1, ...]``) and the replicated ``obs.telemetry.EpochTelemetry``
    counters (``()`` when telemetry is off)."""

    tick: Any
    qstate: Any
    telemetry: Any = ()


# Plan-object cache statistics, the counterpart of the reference's
# traced-program cache: one entry per (mesh, slot core, statics), so
# churn that stays inside a slot bucket reuses its entry.
_SPMD_PROGRAM_SIGS: set = set()
_SPMD_PROGRAM_STATS = {"misses": 0, "hits": 0}


def spmd_program_cache_stats() -> dict:
    """{"misses": (mesh, core, statics) signatures seen first, "hits":
    repeats}, read by ``obs.metrics``."""
    return dict(_SPMD_PROGRAM_STATS)


def _count_program(sig: tuple) -> bool:
    """Count ``sig`` → True on a miss."""
    if sig in _SPMD_PROGRAM_SIGS:
        _SPMD_PROGRAM_STATS["hits"] += 1
        return False
    _SPMD_PROGRAM_SIGS.add(sig)
    _SPMD_PROGRAM_STATS["misses"] += 1
    return True


class CompiledSpmdPipeline(QueryRouting):
    """One ``PipelineSpec`` on one rank of a ``DataMesh`` (see the module
    doc). ``run_epoch`` returns ``(state', WindowAnswers)`` with tenants,
    ``(state, (sum, mean))`` per-window ``QueryResult``s without."""

    def __init__(self, spec: PipelineSpec, mesh, *, axis_name: str = "data"):
        if axis_name != mesh.axis_name:
            raise SpecError(f"mesh has no axis {axis_name!r} "
                            f"(axes: ({mesh.axis_name!r},))")
        r = specmod.resolve(spec)
        self.spec = spec
        self.mesh = mesh
        self.axis_name = axis_name
        self.device = mesh.device
        self.n_devices = mesh.size
        self.plan = r.plan
        self.tenant_names = tuple(t.name for t in spec.tenants)
        self.local_budget = int(r.sample_sizes[0])
        self.max_local_budget = int(r.max_sample_sizes[0])
        self.root_budget = int(r.sample_sizes[-1])
        self.telemetry_enabled = spec.telemetry.enabled
        # plan objects this pipeline had to build (no program is traced)
        self.trace_counter = {"traces": 0}
        if self.plan is not None:
            self._count(self.plan.core)

    def _count(self, core) -> None:
        m = self.mesh
        sig = ((m.rank, m.size, m.backend, str(m.device)), self.axis_name,
               core, self.max_local_budget, self.spec.topology.num_strata,
               self.spec.sampler.allocation, self.spec.sampler.backend,
               self.telemetry_enabled)
        if _count_program(sig):
            self.trace_counter["traces"] += 1

    # ---------------------------------------------------- tenant churn --
    def _with_plan(self, plan, tenants) -> "CompiledSpmdPipeline":
        pipe = object.__new__(CompiledSpmdPipeline)
        pipe.__dict__.update(self.__dict__)
        pipe.plan = plan
        pipe.tenant_names = plan.tenant_names
        pipe.spec = dataclasses.replace(self.spec, tenants=tuple(tenants))
        if plan.core is not self.plan.core:
            pipe._count(plan.core)
        return pipe

    def _sync_telemetry_slots(self, state, n_out: int):
        """The telemetry ``slot_rel_bound_sum`` leaf follows a churned
        core's padded answer width."""
        tel = state.telemetry
        if not hasattr(tel, "slot_rel_bound_sum"):
            return state
        cur = tel.slot_rel_bound_sum
        if cur.shape[0] == n_out:
            return state
        if cur.shape[0] < n_out:
            new = torch.cat([cur, cur.new_zeros(n_out - cur.shape[0])])
        else:
            new = cur[:n_out]
        return state._replace(
            telemetry=tel._replace(slot_rel_bound_sum=new))

    def admit(self, state: SpmdPipelineState, tenant
              ) -> tuple["CompiledSpmdPipeline", SpmdPipelineState]:
        """Hot admission on every rank: the tenant's slot is activated in
        this rank's rows (``slot_axis=1``) and the replicated mask."""
        if self.plan is None:
            raise SpecError("admit() needs a tenanted pipeline — compile "
                            "with at least one TenantSpec")
        try:
            new_plan, transform = self.plan.admit(tenant.name,
                                                  tuple(tenant.queries))
        except (KeyError, ValueError) as e:
            raise SpecError(str(e)) from e
        state = self._sync_telemetry_slots(
            state._replace(qstate=transform(state.qstate, 1)),
            new_plan.core.n_out)
        return (self._with_plan(new_plan, self.spec.tenants + (tenant,)),
                state)

    def retire(self, state: SpmdPipelineState, tenant_id: str
               ) -> tuple["CompiledSpmdPipeline", SpmdPipelineState]:
        """Retirement on every rank: the slot's mask bit goes off; its
        rows freeze and a later admit recycles the slot."""
        if self.plan is None:
            raise SpecError("retire() needs a tenanted pipeline")
        try:
            new_plan, transform = self.plan.retire(tenant_id)
        except (KeyError, ValueError) as e:
            raise SpecError(str(e)) from e
        state = self._sync_telemetry_slots(
            state._replace(qstate=transform(state.qstate, 1)),
            new_plan.core.n_out)
        return (self._with_plan(
            new_plan, tuple(t for t in self.spec.tenants
                            if t.name != tenant_id)), state)

    # -------------------------------------------------------------- state --
    @property
    def default_key(self) -> torch.Tensor:
        return prng.PRNGKey(self.spec.seed, device=self.device)

    def init(self, key=None):
        """Fresh state: with tenants, global tick 0 and this rank's empty
        sketch rows; without, the stateless path's ``()``."""
        del key
        if self.plan is None:
            return ()
        # the sketch leaves are per rank (``launch.sharding``): this
        # rank's row of the reference's [N, ...] leaves
        rows = _tree_map(lambda v: v[None].clone(),
                         self.plan.init_state(self.device))
        tel = ()
        if self.telemetry_enabled:
            from repro_torch.obs.telemetry import EpochTelemetry

            # one merged "level"; no per-stratum root telemetry on the
            # summary-merge path
            tel = EpochTelemetry.create(1, 0, self.plan.core.n_out,
                                        device=self.device)
        return SpmdPipelineState(
            tick=torch.zeros((), dtype=torch.int32, device=self.device),
            qstate=rows, telemetry=tel)

    def gather_state(self, state: SpmdPipelineState) -> SpmdPipelineState:
        """The whole mesh's state in the reference's layout: every
        per-rank leaf gathered to ``[N, ...]`` in rank order (a
        collective: call it on every rank)."""
        if self.plan is None:
            return state
        return state._replace(qstate=_tree_map(
            lambda v: self.mesh.all_gather(v[0]), state.qstate))

    def telemetry_snapshot(self, state) -> dict | None:
        from repro_torch.obs.telemetry import snapshot

        return snapshot(state)

    def clamp_budgets(self, budgets) -> float:
        """The applied level-0 budget clamped to [1, ceiling]; a scalar or
        the per-level list every driver passes."""
        if budgets is None:
            return float(self.local_budget)
        if np.ndim(budgets) > 0:
            budgets = np.asarray(budgets).reshape(-1)[0]
        return min(max(float(budgets), 1.0), float(self.max_local_budget))

    def _check_batches(self, batches: IntervalBatch) -> None:
        m = batches.value.shape[-1]
        if m % self.n_devices:
            raise SpecError(
                f"the interval item axis ({m} slots) must divide evenly "
                f"across mesh axis {self.axis_name!r} ({self.n_devices} "
                f"devices) — pad the epoch batches to a multiple of the "
                f"axis size (padding slots carry valid=False)")

    def _shard(self, batches: IntervalBatch) -> IntervalBatch:
        """This rank's columns of the epoch batch, on its device."""
        w = batches.value.shape[-1] // self.n_devices
        lo = self.mesh.rank * w
        dev = self.device

        def cols(v, dtype):
            return torch.as_tensor(v)[:, lo:lo + w].to(dev, dtype)

        return IntervalBatch(
            value=cols(batches.value, torch.float32),
            stratum=cols(batches.stratum, torch.int32),
            valid=cols(batches.valid, torch.bool),
            meta=StratumMeta(
                torch.as_tensor(batches.meta.weight).to(dev, torch.float32),
                torch.as_tensor(batches.meta.count).to(dev, torch.float32)))

    def run_epoch(self, state, key, batches: IntervalBatch, budgets=None):
        """``T`` windows. ``batches`` leaves carry a leading tick axis
        (``value[T, M]``, the whole item axis; each rank keeps its
        columns), numpy arrays or tensors.

        Tenant path: window ``i`` folds the global tick ``state.tick + i``
        into ``key``; ``budgets`` moves the applied level-0 budget.
        Returns ``(state', WindowAnswers)``; the state given is consumed.
        Without tenants: stateless, window ``i`` folds ``i``; returns
        ``(state, (sum, mean))``."""
        self._check_batches(batches)
        key = torch.as_tensor(key, dtype=torch.int64, device=self.device)
        local = self._shard(batches)
        spec = self.spec
        if self.plan is None:
            if budgets is not None:
                raise SpecError("budgets are inputs of the tenant query "
                                "plane only — the no-tenant SPMD path "
                                "takes the spec's budgets")
            if spec.sampler.mode == "srs":
                return state, T.spmd_srs_epoch(
                    key, local, mesh=self.mesh,
                    fraction=float(spec.sampler.fraction))
            return state, T.spmd_local_then_root_epoch(
                key, local, mesh=self.mesh,
                num_strata=spec.topology.num_strata,
                local_budget=self.local_budget,
                root_budget=self.root_budget,
                allocation=spec.sampler.allocation,
                backend=spec.sampler.backend)
        b = torch.tensor(self.clamp_budgets(budgets), dtype=torch.float32,
                         device=self.device)
        t0 = int(state.tick)   # the one host read of the epoch
        n_ticks = local.value.shape[0]
        q_local = _tree_map(lambda v: v[0], state.qstate)
        q_final, outs = T.spmd_query_plane_epoch(
            key, t0, b, local, q_local, self.plan.core, mesh=self.mesh,
            max_budget=self.max_local_budget,
            num_strata=spec.topology.num_strata,
            allocation=spec.sampler.allocation,
            backend=spec.sampler.backend)
        ok, se, sv, me, mv, nsel, hist, ans, bnd = outs
        ts = (torch.arange(n_ticks, dtype=torch.int32, device=self.device)
              + t0)
        tel = state.telemetry
        if self.telemetry_enabled:
            tel = self._telemetry(tel, local, outs)
        state = SpmdPipelineState(
            tick=state.tick + n_ticks,
            qstate=_tree_map(lambda v: v[None], q_final), telemetry=tel)
        # padded slot vector → the public live-tenant vector
        ans, bnd = self.plan.compact(ans), self.plan.compact(bnd)
        wa = WindowAnswers(
            tick=ts, ok=ok, sum=se, sum_var=sv, mean=me, mean_var=mv,
            n_sampled=nsel, histogram=hist, answers=ans, bounds=bnd,
            # no item crosses a rank: the forwarded channel is empty
            n_forwarded=torch.zeros((n_ticks, 1), dtype=torch.int32,
                                    device=self.device))
        return state, wa

    def _telemetry(self, tel, local: IntervalBatch, outs):
        """The epoch's counters, from merged (replicated) outputs only;
        ``merge_bytes`` adds windows × the live tenants' byte model."""
        ok, se, sv, _, _, nsel, _, ans, bnd = outs
        off_t = self.mesh.psum(
            local.valid.sum(dim=1, dtype=torch.int32)).float()
        kept_t = nsel.float()
        rel = bnd / torch.clamp_min(ans.abs(), 1e-9)
        windows = ok.sum(dtype=torch.int32)
        return tel._replace(
            items_in=tel.items_in + off_t.sum(),
            items_kept=tel.items_kept + kept_t.sum(),
            flushes=tel.flushes + windows,
            saturation_hits=tel.saturation_hits
            + (ok & (kept_t >= off_t)).sum(dtype=torch.int32),
            windows=tel.windows + windows,
            root_sum=tel.root_sum + torch.where(ok, se, 0.0).sum(),
            root_sum_var=tel.root_sum_var + torch.where(ok, sv, 0.0).sum(),
            slot_rel_bound_sum=tel.slot_rel_bound_sum
            + torch.where(ok[:, None], rel, 0.0).sum(dim=0),
            merge_bytes=tel.merge_bytes
            + windows.float() * float(self.summary_bytes_per_window))

    # ---------------------------------------------------------- byte model --
    @property
    def summary_bytes_per_window(self) -> int:
        """Upper bound on the bytes a rank ships per window on the tenant
        path: quantile value/weight buffers, count-min tables and top-k
        keys, the CLT and histogram moments, and the built-in workload's
        per-stratum reductions (the reference's model). Compare
        ``reservoir_bytes_per_window``."""
        if self.plan is None:
            return 0
        n = 0
        for p in self.plan.plans:
            for sp in p.specs:
                if sp.kind == "quantile":
                    n += (2 * sp.capacity + 1) * 4      # value+weight+comps
                elif sp.kind == "heavy_hitters":
                    n += (sp.depth * sp.width + sp.k) * 4  # CM sum + keys
                elif sp.kind == "histogram":
                    n += 2 * sp.bins * 4                # est + var sums
                else:
                    n += 3 * 4                          # est/var/share
        x = self.spec.topology.num_strata
        return n + (64 + 4 * x + 8) * 4  # built-in hist + moments + scalars

    @property
    def reservoir_bytes_per_window(self) -> int:
        """What the same window costs when compacted reservoirs cross
        instead (value f32 + stratum i32 + valid per kept item, plus the
        W/C sets): the no-tenant path's gather."""
        x = self.spec.topology.num_strata
        return self.local_budget * (4 + 4 + 1) + 2 * x * 4
