"""``compile(spec, device=...) → CompiledPipeline`` — the port's runtime.

The counterpart of ``repro.api.pipeline``:

* ``init()`` → ``PipelineState``: every level's buffers and the tenants'
  sketch state on the device, plus the next global tick.
* ``run_epoch(state, key, values, strata, counts, budgets)`` →
  ``(state', WindowAnswers)``: ``T`` ticks of the scan engine
  (``core.tree``). The tick counter is read back once per epoch and
  nothing inside the tick loop waits for the device. Where the tracer
  records (``obs.trace``), the call leaves the spans ``run_epoch`` →
  ``ingest_copy``, ``tick_read``, ``priorities``, ``tick`` × ``T``.
* ``step(...)``: ``run_epoch`` with ``T = 1``.
* ``QueryRouting`` (``rows``, ``query_layout``, ``answer``,
  ``tenant_answers``, ``tenant_rel_errors``): per-tenant routing of the
  standing queries' answers and bounds; ``reset_queries`` empties the
  sketches.

``program_cache_stats`` counts program signatures seen and repeated,
the counterpart of the reference's program cache (each pipeline builds
its own tick and epoch closures, which cost next to nothing).

Tenant churn: ``admit(state, tenant)`` and ``retire(state, name)`` return
a new ``(pipeline, state)`` pair, the slot mask and sketch rows edited in
the state; the pipeline builds new closures only where the slot plan's
core changed (a new group, or a bucket that grew). Checkpoints:
``save_state``/``restore_state`` write and read the reference's format
(``checkpoint.manager``), the spec and the slot manifest in its
metadata.

The pipeline runs on a CUDA device unless ``device="cpu"`` is asked for
(see ``repro_torch.device``). ``budgets`` are per-level sample sizes,
clamped to the provisioned ceilings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.api import spec as specmod
from repro_torch.api.spec import PipelineSpec, SpecError
from repro_torch.core import prng
from repro_torch.core import tree as T
from repro_torch.core.window import TreeState
from repro_torch.device import resolve_device
from repro_torch.obs.trace import get_tracer, span


class PipelineState(NamedTuple):
    """The hierarchy's buffers (``core.window.TreeState``) plus the next
    global tick (i32 scalar on the device)."""

    tree: TreeState
    tick: Any


class WindowAnswers(NamedTuple):
    """One epoch's stacked per-window outputs (leading axis = tick).
    ``ok`` masks ticks whose root window flushed items; ``answers`` and
    ``bounds`` are the tenants' flat ``[T, n_out]`` vectors (``None``
    without tenants); ``n_forwarded`` is the per-(tick, level)
    forwarded-item count."""

    tick: Any
    ok: Any
    sum: Any
    sum_var: Any
    mean: Any
    mean_var: Any
    n_sampled: Any
    histogram: Any
    answers: Any
    bounds: Any
    n_forwarded: Any


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class QueryRouting:
    """Per-tenant answer routing and error attribution over the compiled
    tenant plan (``self.plan``, or ``None``) — the reference's
    ``QueryRouting``."""

    plan = None
    tenant_names: tuple = ()

    def rows(self, wa: WindowAnswers) -> list[dict]:
        """Host-side result rows, one dict per flushed root window, with
        ``answers`` and ``bounds`` when tenants are registered."""
        ts, ok, se, sv, me, mv, nsel, hist = (
            _host(x) for x in
            (wa.tick, wa.ok, wa.sum, wa.sum_var, wa.mean, wa.mean_var,
             wa.n_sampled, wa.histogram))
        ans = _host(wa.answers) if wa.answers is not None else None
        bnd = _host(wa.bounds) if wa.bounds is not None else None
        out = []
        for i in range(len(ts)):
            if not ok[i]:
                continue
            row = dict(tick=int(ts[i]), sum=float(se[i]),
                       sum_var=float(sv[i]), mean=float(me[i]),
                       mean_var=float(mv[i]), n_sampled=int(nsel[i]),
                       histogram=hist[i])
            if ans is not None:
                row["answers"], row["bounds"] = ans[i], bnd[i]
            out.append(row)
        return out

    def query_layout(self, tenant: str | None = None) -> dict:
        """name → (offset, width, kind) into the flat answer vector.
        With several tenants names are ``"tenant/query"``; pass
        ``tenant=`` for one tenant's block with local names and absolute
        offsets."""
        if self.plan is None:
            raise SpecError("this pipeline registers no query tenants")
        if tenant is None:
            return self.plan.layout()
        if len(self.tenant_names) == 1:
            if tenant != self.tenant_names[0]:
                raise KeyError(f"unknown tenant {tenant!r}; registered: "
                               f"{list(self.tenant_names)}")
            return self.plan.layout()
        base, _ = self.plan.tenant_slice(tenant)
        return {q: (base + o, w, kind) for q, (o, w, kind)
                in self.plan.plan_for(tenant).layout().items()}

    def answer(self, vec, name: str, tenant: str | None = None):
        """Slice one query's answers out of a flat vector (array or
        tensor); with several tenants pass ``tenant=`` or a
        ``"tenant/query"`` name."""
        lay = self.query_layout(tenant)
        if name not in lay:
            raise KeyError(f"unknown query {name!r}; available: "
                           f"{sorted(lay)}")
        o, w, _ = lay[name]
        return _host(vec)[..., o:o + w]

    def tenant_answers(self, vec, tenant: str):
        """One tenant's block of a flat answers/bounds vector."""
        if self.plan is None:
            raise SpecError("this pipeline registers no query tenants")
        if len(self.tenant_names) == 1:
            if tenant != self.tenant_names[0]:
                raise KeyError(f"unknown tenant {tenant!r}; registered: "
                               f"{list(self.tenant_names)}")
            return _host(vec)[..., :self.plan.n_out]
        o, w = self.plan.tenant_slice(tenant)
        return _host(vec)[..., o:o + w]

    def tenant_rel_errors(self, answers_row, bounds_row) -> dict[str, float]:
        """Per-tenant measured relative error of one window (see
        ``query.compiler.tenant_rel_errors``)."""
        from repro_torch.query.compiler import tenant_rel_errors

        if self.plan is None:
            return {}
        return tenant_rel_errors(self.plan, answers_row, bounds_row,
                                 default_tenant=self.tenant_names[0])


# Program signatures seen so far. The tick and epoch functions are plain
# closures, cheap to build, so each pipeline builds its own; the set only
# counts what the reference's program cache would build and reuse. The
# plan component is the canonical ``SlotPlanCore``, which the plan cache
# (``query.compiler``) already keeps alive.
_PROGRAM_SIGS: set = set()
_PROGRAM_STATS = {"misses": 0, "hits": 0}


def _count_program(sig: tuple) -> None:
    if sig in _PROGRAM_SIGS:
        _PROGRAM_STATS["hits"] += 1
    else:
        _PROGRAM_SIGS.add(sig)
        _PROGRAM_STATS["misses"] += 1


def program_cache_stats() -> dict:
    """{"misses": program signatures seen for the first time, "hits":
    repeats}: a ``compile`` of a spec whose program shape (topology,
    budgets' ceilings, sampler, routing, telemetry, tenant plan) and
    device were seen before counts as a reuse."""
    return dict(_PROGRAM_STATS)


def _sync_telemetry_slots(state: PipelineState, n_out: int
                          ) -> PipelineState:
    """Churn across a slot-bucket boundary changes the core's padded
    answer width; the telemetry ``slot_rel_bound_sum`` leaf follows it
    (zeros padded, or retired tail slots cut) or the next epoch's
    accumulate would not fit."""
    tel = state.tree.telemetry
    if not hasattr(tel, "slot_rel_bound_sum"):
        return state
    cur = tel.slot_rel_bound_sum
    if cur.shape[0] == n_out:
        return state
    if cur.shape[0] < n_out:
        new = torch.cat([cur, cur.new_zeros(n_out - cur.shape[0])])
    else:
        new = cur[:n_out]
    return state._replace(tree=state.tree._replace(
        telemetry=tel._replace(slot_rel_bound_sum=new)))


class CompiledPipeline(QueryRouting):
    """One ``PipelineSpec`` bound to one device (see the module doc).

    ``admit``/``retire`` return a new ``(pipeline, state)`` pair; the
    pipeline given and its programs stay as they were."""

    def __init__(self, spec: PipelineSpec, device: torch.device):
        r = specmod.resolve(spec)
        self.spec = spec
        self.device = device
        self.fanin = list(spec.topology.fanin)
        self.num_strata = spec.topology.num_strata
        self.capacities = list(r.capacities)
        self.sample_sizes = list(r.sample_sizes)
        self.max_sample_sizes = list(r.max_sample_sizes)
        self.interval_ticks = list(r.interval_ticks)
        self.telemetry_enabled = spec.telemetry.enabled
        self.route_keys = spec.strata.num_keys
        self.plan = r.plan
        self.tenant_names = tuple(t.name for t in spec.tenants)
        self._p_level = r.p_level
        self._build_programs(r.plan.core if r.plan is not None else None)

    def _build_programs(self, core) -> None:
        """The tick and epoch closures over the slot plan's ``core``,
        counted in ``program_cache_stats``."""
        spec = self.spec
        self._traced_plan = core
        _count_program((
            tuple(self.fanin), tuple(self.capacities),
            tuple(self.max_sample_sizes), tuple(self.interval_ticks),
            self.num_strata, spec.sampler.allocation, spec.sampler.backend,
            spec.sampler.mode, self._p_level, spec.sampler.fraction,
            self.route_keys, self.telemetry_enabled, core, self.device))
        self._tick_fn = T._build_scan_tick(
            self.fanin, self.capacities, self.max_sample_sizes,
            self.interval_ticks, self.num_strata, spec.sampler.allocation,
            spec.sampler.backend, spec.sampler.mode, self._p_level,
            spec.sampler.fraction, self.device,
            telemetry=self.telemetry_enabled, plan=core)
        self._epoch_fn = T._build_epoch_fn(self._tick_fn, self.fanin,
                                           self.capacities, plan=core)

    # ---------------------------------------------------- tenant churn --
    def _with_plan(self, plan, tenants) -> "CompiledPipeline":
        """A clone carrying a new tenant plan (and the spec with the
        edited ``tenants``), sharing this pipeline's closures unless the
        plan's core changed."""
        pipe = object.__new__(CompiledPipeline)
        pipe.__dict__.update(self.__dict__)
        pipe.plan = plan
        pipe.tenant_names = plan.tenant_names
        pipe.spec = dataclasses.replace(self.spec, tenants=tuple(tenants))
        if plan.core is not self._traced_plan:
            pipe._build_programs(plan.core)
        return pipe

    def admit(self, state: PipelineState, tenant
              ) -> tuple["CompiledPipeline", PipelineState]:
        """Hot-admit one tenant (a ``TenantSpec``) mid-stream →
        ``(pipeline', state')``, the tenant's slot active with its sketch
        rows at init. The answers are bitwise those of a fresh compile of
        the same live set from the same state."""
        if self.plan is None:
            raise SpecError("admit() needs a tenanted pipeline — compile "
                            "with at least one TenantSpec")
        with span("admit", tenant=tenant.name):
            try:
                new_plan, transform = self.plan.admit(tenant.name,
                                                      tuple(tenant.queries))
            except (KeyError, ValueError) as e:
                raise SpecError(str(e)) from e
            state = state._replace(tree=state.tree._replace(
                qstate=transform(state.tree.qstate)))
            state = _sync_telemetry_slots(state, new_plan.core.n_out)
            return self._with_plan(new_plan,
                                   self.spec.tenants + (tenant,)), state

    def retire(self, state: PipelineState, tenant_id: str
               ) -> tuple["CompiledPipeline", PipelineState]:
        """Retire a live tenant: its slot's mask bit goes off (a later
        ``admit`` recycles the slot). Inactive slots answer zeros, keep
        their frozen state and never vote in budget arbitration."""
        if self.plan is None:
            raise SpecError("retire() needs a tenanted pipeline")
        with span("retire", tenant=tenant_id):
            try:
                new_plan, transform = self.plan.retire(tenant_id)
            except (KeyError, ValueError) as e:
                raise SpecError(str(e)) from e
            state = state._replace(tree=state.tree._replace(
                qstate=transform(state.tree.qstate)))
            state = _sync_telemetry_slots(state, new_plan.core.n_out)
            return self._with_plan(
                new_plan, tuple(t for t in self.spec.tenants
                                if t.name != tenant_id)), state

    @property
    def default_key(self) -> torch.Tensor:
        """The spec-seeded key (``PRNGKey(spec.seed)``) on the device."""
        return prng.PRNGKey(self.spec.seed, device=self.device)

    def init(self, key=None) -> PipelineState:
        """Fresh state: empty buffers, identity metadata, empty sketches,
        tick 1. ``key`` is accepted for symmetry with the reference
        (initialisation is deterministic)."""
        del key
        tel = ()
        if self.telemetry_enabled:
            from repro_torch.obs.telemetry import EpochTelemetry

            tel = EpochTelemetry.create(
                len(self.fanin), self.num_strata,
                self._traced_plan.n_out if self._traced_plan is not None else 0,
                device=self.device)
        route = ()
        if self.route_keys:
            route = (torch.arange(self.route_keys, dtype=torch.int32,
                                  device=self.device) % self.num_strata)
        qstate = (self.plan.init_state(self.device)
                  if self.plan is not None else ())
        st = TreeState.create(self.fanin, self.capacities, self.num_strata,
                              device=self.device, qstate=qstate,
                              telemetry=tel, route=route)
        return PipelineState(tree=st, tick=torch.tensor(
            1, dtype=torch.int32, device=self.device))

    def telemetry_snapshot(self, state: PipelineState) -> dict | None:
        """Host-readable telemetry (``None`` when telemetry is off)."""
        from repro_torch.obs.telemetry import snapshot

        return snapshot(state)

    def clamp_budgets(self, budgets) -> list[float]:
        """Per-level budgets clamped to [1, ceiling]: the buffers upstream
        were sized for the ceilings."""
        if budgets is None:
            budgets = self.sample_sizes
        budgets = list(budgets)
        if len(budgets) != len(self.fanin):
            raise SpecError(
                f"budgets must have one entry per level: got "
                f"{len(budgets)} for {len(self.fanin)} levels")
        return [min(max(float(s), 1.0), float(m))
                for s, m in zip(budgets, self.max_sample_sizes)]

    def run_epoch(self, state: PipelineState, key, values, strata, counts,
                  budgets=None) -> tuple[PipelineState, WindowAnswers]:
        """Advance ``T = values.shape[0]`` ticks.

        ``values``/``strata`` are ``[T, fanin[0], width]`` tick-major
        padded ingest (``data.stream.batch_ingest`` builds it), ``counts``
        the ``[T, fanin[0]]`` item counts; numpy arrays or tensors, moved
        to the device in one copy each. As the reference's epoch is
        donated, ``state`` is consumed: its buffers may be reused for the
        returned state, so do not use the argument after the call.
        """
        dev = self.device
        tracer = get_tracer()
        with tracer.epoch_span("run_epoch", ticks=len(counts)):
            with tracer.span("ingest_copy") as meta:
                given = (values, strata, counts)
                values = torch.as_tensor(values, dtype=torch.float32,
                                         device=dev)
                strata = torch.as_tensor(strata, dtype=torch.int32,
                                         device=dev)
                counts = torch.as_tensor(counts, dtype=torch.int32,
                                         device=dev)
                if meta is not None:
                    # bytes moved onto the device: 0 for its own tensors
                    meta["bytes"] = sum(
                        t.nbytes for x, t in zip(given,
                                                 (values, strata, counts))
                        if not (torch.is_tensor(x) and x.device == t.device))
                    tracer.count("ingest_bytes", meta["bytes"])
            epoch_ticks, n0 = counts.shape
            if n0 != self.fanin[0]:
                raise SpecError(f"ingest rows must match level-0 nodes: got "
                                f"{n0} for fanin {tuple(self.fanin)}")
            b = torch.tensor(self.clamp_budgets(budgets), dtype=torch.float32,
                             device=dev)
            key = torch.as_tensor(key, dtype=torch.int64, device=dev)
            with tracer.span("tick_read"):
                t0 = int(state.tick)  # the one host read of the epoch
            tree, outs = self._epoch_fn(state.tree, key, t0, b, values,
                                        strata, counts)
            if self.plan is not None:
                ts, ok, se, sv, me, mv, nsel, hist, ans, bnd, n_fwd = outs
                # The core answers the padded slot vector; the public
                # vector is the live tenants' blocks.
                ans, bnd = self.plan.compact(ans), self.plan.compact(bnd)
            else:
                ts, ok, se, sv, me, mv, nsel, hist, n_fwd = outs
                ans = bnd = None
            wa = WindowAnswers(tick=ts, ok=ok, sum=se, sum_var=sv, mean=me,
                               mean_var=mv, n_sampled=nsel, histogram=hist,
                               answers=ans, bounds=bnd, n_forwarded=n_fwd)
            return (PipelineState(tree=tree, tick=state.tick + epoch_ticks),
                    wa)

    def step(self, state: PipelineState, key, values, strata, counts,
             budgets=None) -> tuple[PipelineState, WindowAnswers]:
        """One tick (``values`` ``[fanin[0], width]``)."""
        return self.run_epoch(state, key, torch.as_tensor(values)[None],
                              torch.as_tensor(strata)[None],
                              torch.as_tensor(counts)[None], budgets)

    def reset_queries(self, state: PipelineState) -> PipelineState:
        """Empty the standing queries' sketch state (called after a
        warm-up, the answers cover only the measured ticks)."""
        if self.plan is None:
            return state
        return state._replace(tree=state.tree._replace(
            qstate=self.plan.init_state(self.device)))


# ------------------------------------------------------- checkpointing --
def save_state(root, step: int, state: PipelineState, *,
               spec: PipelineSpec | None = None,
               pipeline: CompiledPipeline | None = None, keep_n: int = 3):
    """Checkpoint a ``PipelineState`` (atomic, keep-N, the reference's
    format: see ``checkpoint.manager``). ``spec`` rides in the manifest so
    a restore can check it loads into the same pipeline; ``pipeline=``
    (preferred) also records the slot configuration, which a churned
    pipeline's spec alone cannot rebuild (retirement leaves slot holes).
    With a mesh pipeline (``api.spmd``) every rank calls this: the ranks'
    sketch rows are gathered and rank 0 writes the reference's ``[N,
    ...]`` layout (the path is returned there, ``None`` on the other
    ranks). Save before handing the state to ``run_epoch``, which
    consumes it."""
    from repro_torch.checkpoint import manager

    if pipeline is not None and spec is None:
        spec = pipeline.spec
    meta = {"pipeline_spec": spec.to_dict()} if spec is not None else {}
    plan = pipeline.plan if pipeline is not None else (
        specmod.build_plan(spec) if spec is not None else None)
    if plan is not None:
        meta["slots"] = plan.slot_manifest()
    mesh = getattr(pipeline, "mesh", None)
    with span("checkpoint", op="save", step=step):
        if mesh is None:
            return manager.save(root, step, state, meta=meta, keep_n=keep_n)
        # a mesh pipeline: every rank's sketch rows gathered into the
        # reference's [N, ...] layout, written once, by rank 0
        state = pipeline.gather_state(state)
        path = None
        if mesh.rank == 0:
            path = manager.save(root, step, state, meta=meta, keep_n=keep_n)
        mesh.barrier()
        return path


def restore_state(root, compiled: CompiledPipeline, step: int | None = None
                  ) -> tuple[PipelineState, dict]:
    """Load a checkpointed ``PipelineState`` into ``compiled``'s state
    template, on its device (default: the latest step under ``root``) →
    ``(state, meta)``; a mesh pipeline's rank takes its own row of every
    per-rank leaf. A checkpoint of another spec, or of a pipeline
    whose slots churned differently, is a ``SpecError``: resuming under
    other sampling semantics or slot routing would silently change every
    answer."""
    from repro_torch.checkpoint import manager

    if step is None:
        step = manager.latest_step(root)
        if step is None:
            raise SpecError(f"no pipeline checkpoints under {root!r}")
    # The manifest first: a slot-configuration mismatch must fail with an
    # actionable error, not a leaf-shape error.
    meta = manager.read_manifest(root, step).get("meta", {})
    saved = meta.get("pipeline_spec")
    if saved is not None and saved != compiled.spec.to_dict():
        raise SpecError(
            f"checkpoint at {root!r} step {step} was written by a "
            f"different PipelineSpec — recompile with "
            f"PipelineSpec.from_dict(manifest['pipeline_spec']) or point "
            f"at the right checkpoint directory")
    saved_slots = meta.get("slots")
    if saved_slots is not None and compiled.plan is not None:
        current = compiled.plan.slot_manifest()
        if saved_slots != current:
            raise SpecError(
                f"checkpoint at {root!r} step {step} was written under a "
                f"different tenant-slot configuration "
                f"(saved {saved_slots}, pipeline has {current}) — the "
                f"pipelines churned differently since compile, so "
                f"restoring would silently mis-route tenant answers. "
                f"Admit/retire this pipeline to the saved live set (same "
                f"order) or restore into a pipeline compiled from the "
                f"checkpoint's spec before any churn.")
    target = compiled.init()
    shardings = None
    if getattr(compiled, "mesh", None) is not None and len(target):
        from repro_torch.launch.sharding import spmd_state_shardings

        shardings = spmd_state_shardings(target, compiled.mesh)
    with span("checkpoint", op="restore", step=step):
        return manager.restore(root, step, target, shardings=shardings)


def compile(spec: PipelineSpec, *, device=None, mesh=None):
    """The front door: ``PipelineSpec → CompiledPipeline`` on ``device``
    (``"cuda"`` by default; it raises where there is no CUDA device,
    and ``device="cpu"`` runs the plain PyTorch path). With ``mesh`` (a
    rank's ``launch.mesh.DataMesh``) the spec lowers onto the mesh data
    plane instead, on the mesh's device: ``api.spmd.CompiledSpmdPipeline``,
    compiled on every rank."""
    if not isinstance(spec, PipelineSpec):
        raise SpecError(f"compile() takes a repro_torch PipelineSpec, got "
                        f"{type(spec).__name__} — build one with "
                        f"PipelineSpec(...) or PipelineSpec.from_dict(...)")
    if mesh is not None:
        from repro_torch.api.spmd import CompiledSpmdPipeline

        if device is not None and torch.device(device) != mesh.device:
            raise SpecError(f"device={device!r} disagrees with the mesh "
                            f"rank's device {mesh.device}")
        return CompiledSpmdPipeline(spec, mesh)
    return CompiledPipeline(spec, resolve_device(
        "cuda" if device is None else device))
