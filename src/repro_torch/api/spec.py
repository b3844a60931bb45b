"""``PipelineSpec`` — the declarative job description, the port's own copy.

One frozen, serializable value describes the job: the edge topology
(fan-in per level, buffer capacity, per-level flush intervals), the
sampler (WHS or the SRS baseline, selection backend, stratum allocation,
end-to-end fraction) and the budget policy. ``repro_torch.compile(spec)``
turns it into an ``init``/``run_epoch`` pipeline; :func:`resolve` derives
every runtime quantity with the reference's formulas, so one spec drives
both packages to the same buffers and budgets.

The standing-query plane is a list of per-**tenant** query registries
(``TenantSpec``); :func:`resolve` compiles them into one slotted plan.
``to_dict()``/``from_dict()`` round-trip the spec through plain JSON
types and read the reference's ``PipelineSpec.to_dict()``, tenants
included.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

from repro_torch.query.registry import QuerySpec


class SpecError(ValueError):
    """A pipeline spec that cannot be compiled, with a pointer to the
    offending field and the constraint it violates."""


_MODES = ("whs", "srs")
_BACKENDS = ("argsort", "topk", "pallas", "pallas_fused")
_ALLOCATIONS = ("fair", "proportional", "neyman")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The emulated edge hierarchy: ``fanin[l]`` nodes at level ``l``
    (root last, always 1), a level-0 buffer ``capacity`` (upper levels
    are provisioned automatically from the budget ceilings), per-level
    flush ``interval_ticks`` (default all-1 — the paper topology), and
    the number of sub-streams (``num_strata``)."""

    fanin: tuple = (4, 2, 1)
    capacity: int = 1024
    interval_ticks: tuple | None = None
    num_strata: int = 4

    def __post_init__(self):
        object.__setattr__(self, "fanin", tuple(int(n) for n in self.fanin))
        _require(len(self.fanin) >= 1,
                 "topology.fanin must name at least one level")
        _require(all(n >= 1 for n in self.fanin),
                 f"topology.fanin must be positive node counts, got "
                 f"{self.fanin}")
        _require(self.fanin[-1] == 1,
                 f"topology.fanin must end at a single root node, got "
                 f"{self.fanin} (last level is {self.fanin[-1]}, expected 1)")
        _require(int(self.capacity) >= 1,
                 f"topology.capacity must be >= 1, got {self.capacity}")
        object.__setattr__(self, "capacity", int(self.capacity))
        _require(int(self.num_strata) >= 1,
                 f"topology.num_strata must be >= 1, got {self.num_strata}")
        object.__setattr__(self, "num_strata", int(self.num_strata))
        if self.interval_ticks is not None:
            iv = tuple(int(i) for i in self.interval_ticks)
            _require(len(iv) == len(self.fanin),
                     f"topology.interval_ticks must have one entry per "
                     f"level: got {len(iv)} for {len(self.fanin)} levels")
            _require(all(i >= 1 for i in iv),
                     f"topology.interval_ticks must be >= 1 ticks, got {iv}")
            object.__setattr__(self, "interval_ticks", iv)

    @property
    def n_levels(self) -> int:
        return len(self.fanin)


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Which sampler runs at every node: the paper's weighted
    hierarchical sampler (``whs``) or the §IV-B stratified-random
    baseline (``srs``), the selection ``backend`` (see
    ``core.sampling``), the per-stratum budget ``allocation``, and the
    end-to-end sampling ``fraction`` (kept-items / offered-items, which
    sizes the default per-level budgets)."""

    mode: str = "whs"
    backend: str = "topk"
    allocation: str = "fair"
    fraction: float | None = 0.1

    def __post_init__(self):
        _require(self.mode in _MODES,
                 f"sampler.mode must be one of {_MODES}, got {self.mode!r}")
        _require(self.backend in _BACKENDS,
                 f"sampler.backend must be one of {_BACKENDS}, got "
                 f"{self.backend!r}")
        _require(self.allocation in _ALLOCATIONS,
                 f"sampler.allocation must be one of {_ALLOCATIONS}, got "
                 f"{self.allocation!r}")
        if self.fraction is not None:
            f = float(self.fraction)
            _require(0.0 < f <= 1.0,
                     f"sampler.fraction must be in (0, 1], got {f}")
            object.__setattr__(self, "fraction", f)


@dataclasses.dataclass(frozen=True)
class BudgetSpec:
    """Per-level sample budgets.

    ``sample_sizes`` pins explicit per-level budgets (default: derived
    from ``sampler.fraction`` × capacity). ``max_fraction`` /
    ``max_sample_sizes`` provision buffer ceilings above the initial
    budgets, so ``run_epoch(..., budgets=)`` can move the budgets up to
    them. ``target_rel_error`` closes the §IV-B loop: the analytics
    driver (``launch.analytics.run_pipeline``) runs
    ``runtime.budget.BudgetController`` (``WorstTenantArbiter`` with
    several tenants), which moves the budgets toward the target within
    ``[min_size, ceiling]`` with gains ``kp`` and ``ki``; without an
    explicit ceiling it provisions full-capacity ones."""

    sample_sizes: tuple | None = None
    max_sample_sizes: tuple | None = None
    max_fraction: float | None = None
    target_rel_error: float | None = None
    min_size: int = 8
    kp: float = 0.5
    ki: float = 0.1

    def __post_init__(self):
        for name in ("sample_sizes", "max_sample_sizes"):
            v = getattr(self, name)
            if v is not None:
                v = tuple(int(s) for s in v)
                _require(all(s >= 1 for s in v),
                         f"budget.{name} must be positive, got {v}")
                object.__setattr__(self, name, v)
        if self.max_fraction is not None:
            f = float(self.max_fraction)
            _require(0.0 < f <= 1.0,
                     f"budget.max_fraction must be in (0, 1], got {f}")
            object.__setattr__(self, "max_fraction", f)
        if self.target_rel_error is not None:
            _require(float(self.target_rel_error) > 0.0,
                     f"budget.target_rel_error must be > 0, got "
                     f"{self.target_rel_error}")

    @property
    def policy(self) -> str:
        return "fixed" if self.target_rel_error is None else "error_budget"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's standing-query registry. Every tenant's queries are
    answered from the same shared tree (one root evaluation per window),
    with per-tenant answer routing and error attribution."""

    name: str
    queries: tuple = ()

    def __post_init__(self):
        _require(bool(self.name) and isinstance(self.name, str),
                 f"tenant name must be a non-empty string, got {self.name!r}")
        _require("/" not in self.name,
                 f"tenant name {self.name!r} may not contain '/' (reserved "
                 f"for tenant/query answer routing)")
        qs = tuple(self.queries)
        _require(len(qs) >= 1,
                 f"tenant {self.name!r} registers no queries — drop the "
                 f"tenant or add QuerySpecs")
        for q in qs:
            _require(isinstance(q, QuerySpec),
                     f"tenant {self.name!r}: queries must be QuerySpec "
                     f"instances, got {type(q).__name__}")
        names = [q.name for q in qs]
        _require(len(set(names)) == len(names),
                 f"tenant {self.name!r} has duplicate query names: "
                 f"{sorted(n for n in names if names.count(n) > 1)}")
        object.__setattr__(self, "queries", qs)

    @classmethod
    def from_registry(cls, name: str, registry) -> "TenantSpec":
        """Wrap a ``repro_torch.query.QueryRegistry`` as one tenant."""
        return cls(name=name, queries=tuple(registry.specs))


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """The in-graph observability plane (``repro_torch.obs``).

    ``enabled`` statically compiles the ``EpochTelemetry`` counter
    update into the epoch program: the donated state gains cumulative
    per-level/per-stratum counters and the realized error-bound
    trajectory, read back via ``repro_torch.obs.snapshot``. Telemetry
    consumes no PRNG and runs inside the existing tick, so sample state
    and window answers are bit-identical on or off, at zero extra
    dispatches. Off (the default) carries zero extra state leaves."""

    enabled: bool = False

    def __post_init__(self):
        _require(isinstance(self.enabled, bool),
                 f"telemetry.enabled must be a bool, got "
                 f"{self.enabled!r}")


@dataclasses.dataclass(frozen=True)
class StrataSpec:
    """Key→stratum routing (the reference's adaptive stratification).

    ``num_keys`` > 0 makes ingest stratum ids *keys*, gathered through an
    i32 ``[num_keys]`` table carried in the state (seeded round-robin at
    ``init``). ``adaptive`` has the analytics driver run
    ``strata.StratumManager`` between epochs: slots hotter than
    ``split_occupancy``× their fair share shed keys onto a spare slot,
    slots below ``merge_occupancy``× of it fold into another
    (``strata.remap_tree_state``, a same-shape edit of the table and the
    Eq. 9 metadata). 0 (the default) carries no table."""

    num_keys: int = 0
    adaptive: bool = False
    split_occupancy: float = 2.0
    merge_occupancy: float = 0.05

    def __post_init__(self):
        _require(int(self.num_keys) >= 0,
                 f"strata.num_keys must be >= 0, got {self.num_keys}")
        object.__setattr__(self, "num_keys", int(self.num_keys))
        _require(isinstance(self.adaptive, bool),
                 f"strata.adaptive must be a bool, got {self.adaptive!r}")
        _require(not self.adaptive or self.num_keys > 0,
                 "strata.adaptive needs strata.num_keys > 0 (the routing "
                 "table the manager edits)")
        _require(float(self.split_occupancy) > 1.0,
                 f"strata.split_occupancy is a multiple of the fair share "
                 f"and must be > 1, got {self.split_occupancy}")
        _require(0.0 <= float(self.merge_occupancy) < 1.0,
                 f"strata.merge_occupancy must be in [0, 1), got "
                 f"{self.merge_occupancy}")


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """The whole job: topology × sampler × tenants × budget policy."""

    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)
    sampler: SamplerSpec = dataclasses.field(default_factory=SamplerSpec)
    tenants: tuple = ()
    budget: BudgetSpec = dataclasses.field(default_factory=BudgetSpec)
    seed: int = 0
    telemetry: TelemetrySpec = dataclasses.field(
        default_factory=TelemetrySpec)
    strata: StrataSpec = dataclasses.field(default_factory=StrataSpec)

    def __post_init__(self):
        object.__setattr__(self, "tenants", tuple(self.tenants))
        for t in self.tenants:
            _require(isinstance(t, TenantSpec),
                     f"tenants must be TenantSpec instances, got "
                     f"{type(t).__name__}")
        names = [t.name for t in self.tenants]
        dups = sorted({n for n in names if names.count(n) > 1})
        _require(not dups, f"duplicate tenant names: {dups}")
        _require(isinstance(self.telemetry, TelemetrySpec),
                 f"telemetry must be a TelemetrySpec, got "
                 f"{type(self.telemetry).__name__}")
        _require(isinstance(self.strata, StrataSpec),
                 f"strata must be a StrataSpec, got "
                 f"{type(self.strata).__name__}")
        object.__setattr__(self, "seed", int(self.seed))
        validate(self)

    # -------------------------------------------------- serialization --
    def to_dict(self) -> dict:
        """Plain-JSON-types dict (tuples → lists), round-trips through
        :meth:`from_dict`."""
        d = dataclasses.asdict(self)
        d["version"] = 1

        def listify(x):
            if isinstance(x, tuple):
                return [listify(v) for v in x]
            if isinstance(x, list):
                return [listify(v) for v in x]
            if isinstance(x, dict):
                return {k: listify(v) for k, v in x.items()}
            return x

        return listify(d)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineSpec":
        """Strict inverse of :meth:`to_dict`: unknown keys, missing
        required keys, and mistyped values raise ``SpecError`` naming
        the exact path."""
        _require(isinstance(d, dict),
                 f"pipeline spec must be a dict, got {type(d).__name__}")
        d = dict(d)
        version = d.pop("version", 1)
        _require(version == 1,
                 f"unsupported pipeline spec version {version!r} "
                 f"(this build reads version 1)")
        sections = {
            "topology": TopologySpec, "sampler": SamplerSpec,
            "budget": BudgetSpec, "telemetry": TelemetrySpec,
            "strata": StrataSpec,
        }
        kwargs = {}
        for key, klass in sections.items():
            sub = d.pop(key, None)
            if sub is None:
                continue
            kwargs[key] = _build_section(key, klass, sub)
        tenants = d.pop("tenants", [])
        _require(isinstance(tenants, (list, tuple)),
                 f"tenants must be a list, got {type(tenants).__name__}")
        built = []
        for i, t in enumerate(tenants):
            _require(isinstance(t, dict),
                     f"tenants[{i}] must be a dict, got {type(t).__name__}")
            t = dict(t)
            queries = t.pop("queries", [])
            qspecs = []
            for j, q in enumerate(queries):
                _require(isinstance(q, dict),
                         f"tenants[{i}].queries[{j}] must be a dict, got "
                         f"{type(q).__name__}")
                qspecs.append(_build_section(
                    f"tenants[{i}].queries[{j}]", QuerySpec,
                    {**q, "qs": tuple(q.get("qs", ()))}))
            built.append(_build_section(f"tenants[{i}]", TenantSpec,
                                        {**t, "queries": tuple(qspecs)}))
        kwargs["tenants"] = tuple(built)
        if "seed" in d:
            kwargs["seed"] = d.pop("seed")
        _require(not d, f"unknown pipeline spec keys: {sorted(d)} "
                        f"(known: {sorted(list(sections) + ['tenants', 'seed', 'version'])})")
        return cls(**kwargs)


def _build_section(path: str, klass, payload: dict):
    _require(isinstance(payload, dict),
             f"{path} must be a dict, got {type(payload).__name__}")
    fields = {f.name for f in dataclasses.fields(klass)}
    unknown = sorted(set(payload) - fields)
    _require(not unknown,
             f"{path} has unknown keys {unknown} (known: {sorted(fields)})")
    coerced = {k: tuple(v) if isinstance(v, list) else v
               for k, v in payload.items()}
    try:
        return klass(**coerced)
    except SpecError:
        raise
    except (TypeError, ValueError) as e:
        raise SpecError(f"{path}: {e}") from e


def derive_sample_sizes(spec: PipelineSpec) -> tuple[tuple, tuple]:
    """(sample_sizes, max_sample_sizes) per level — the reference's
    formulas, so one spec sizes both packages' buffers alike."""
    topo, samp, budget = spec.topology, spec.sampler, spec.budget
    n = topo.n_levels
    if budget.sample_sizes is not None:
        sizes = budget.sample_sizes
    elif samp.mode == "srs":
        # Coin-flip keeps ~p of arrivals per level; a level-l node's
        # outbound buffer must hold p^(l+1) of the concentrated stream
        # with slack — truncation would break HT unbiasedness.
        p = samp.fraction ** (1.0 / n)
        total = topo.fanin[0] * topo.capacity
        sizes = tuple(max(int(1.3 * total * (p ** (lvl + 1))
                              / topo.fanin[lvl]), 8) for lvl in range(n))
    else:
        sizes = (max(int(topo.capacity * samp.fraction), 1),) * n
    if budget.max_sample_sizes is not None:
        max_sizes = budget.max_sample_sizes
    elif budget.max_fraction is not None:
        max_sizes = (max(int(topo.capacity * budget.max_fraction), 1),) * n
    elif budget.target_rel_error is not None:
        # Closed-loop accuracy mode grows the sample onto the target:
        # without an explicit ceiling, provision the full window
        # (max_fraction = 1.0), or the ceiling would equal the initial
        # budget and the §IV-B loop could never grow it.
        max_sizes = (max(int(topo.capacity), 1),) * n
    else:
        max_sizes = sizes
    return tuple(sizes), tuple(max_sizes)


class ResolvedPipeline(NamedTuple):
    """Everything the runtime needs, derived once from the spec: applied
    and ceiling per-level budgets, effective intervals, per-level buffer
    capacities, the SRS per-level keep probability and the compiled
    tenant plan (``None`` without tenants)."""

    sample_sizes: tuple
    max_sample_sizes: tuple
    interval_ticks: tuple
    capacities: tuple
    p_level: float
    plan: object   # query.compiler.SlottedTenantPlan | None


def build_plan(spec: PipelineSpec):
    """Compile the tenants' registries into a ``SlottedTenantPlan``
    (``None`` without tenants): tenants group by name-free shape
    signature, each group padded to its slot bucket."""
    if not spec.tenants:
        return None
    from repro_torch.query.compiler import build_slotted_plan

    return build_slotted_plan([(t.name, t.queries) for t in spec.tenants],
                              spec.topology.num_strata)


def slot_bucket(n: int) -> int:
    """Re-export of the slot bucketing rule (see ``query.compiler``)."""
    from repro_torch.query.compiler import slot_bucket as _sb

    return _sb(n)


def resolve(spec: PipelineSpec) -> ResolvedPipeline:
    """Validate and derive every runtime quantity."""
    from repro_torch.core.tree import derive_capacities

    validate(spec)
    topo = spec.topology
    iv = topo.interval_ticks or (1,) * topo.n_levels
    sizes, max_sizes = derive_sample_sizes(spec)
    capacities = tuple(derive_capacities(list(topo.fanin), topo.capacity,
                                         list(max_sizes), list(iv)))
    p_level = (spec.sampler.fraction ** (1.0 / topo.n_levels)
               if spec.sampler.fraction is not None else 1.0)
    return ResolvedPipeline(sample_sizes=sizes, max_sample_sizes=max_sizes,
                            interval_ticks=iv, capacities=capacities,
                            p_level=p_level, plan=build_plan(spec))


def validate(spec: PipelineSpec) -> None:
    """Cross-field checks, with the constraint spelled out."""
    topo, samp, budget = spec.topology, spec.sampler, spec.budget
    n = topo.n_levels
    if samp.mode == "srs":
        _require(samp.fraction is not None,
                 "sampler.mode='srs' needs sampler.fraction (the coin-flip "
                 "keep rate is derived from the end-to-end fraction)")
        _require(not spec.tenants,
                 "query tenants need WHS stratum metadata: use "
                 "sampler.mode='whs' or drop the tenants")
        _require(budget.target_rel_error is None,
                 "the error-budget controller drives WHS sample budgets: "
                 "use sampler.mode='whs' or drop budget.target_rel_error")
    if samp.fraction is None:
        _require(budget.sample_sizes is not None,
                 "set sampler.fraction or pin explicit budget.sample_sizes "
                 "— with neither there is no way to size the per-level "
                 "budgets")
    for name in ("sample_sizes", "max_sample_sizes"):
        v = getattr(budget, name)
        if v is not None:
            _require(len(v) == n,
                     f"budget.{name} must have one entry per level: got "
                     f"{len(v)} for {n} levels (fanin {topo.fanin})")
    sizes, max_sizes = derive_sample_sizes(spec)
    bad = [(lvl, s, m) for lvl, (s, m) in enumerate(zip(sizes, max_sizes))
           if m < s]
    _require(not bad,
             f"budget ceilings must dominate the initial budgets; levels "
             f"{[lvl for lvl, _, _ in bad]} have max < initial "
             f"({[(s, m) for _, s, m in bad]}) — raise max_fraction/"
             f"max_sample_sizes or lower the initial budgets")
    if samp.mode == "whs":
        # A selection can't return more slots than the level holds.
        from repro_torch.core.tree import derive_capacities

        iv = topo.interval_ticks or (1,) * n
        caps = derive_capacities(list(topo.fanin), topo.capacity,
                                 list(max_sizes), list(iv))
        for lvl, (s, cap) in enumerate(zip(sizes, caps)):
            _require(s <= cap,
                     f"level-{lvl} sample budget {s} exceeds the level-"
                     f"{lvl} buffer capacity {cap} — raise "
                     f"topology.capacity or lower the budgets")
    # Error-budget feasibility: a quantile sketch's rank-error floor is set
    # by its capacity, so no sample budget can push its bound below it; a
    # target under that floor could never be met.
    if budget.target_rel_error is not None:
        from repro_torch.query.sketches import quantile_rank_error_bound

        target = float(budget.target_rel_error)
        for t in spec.tenants:
            for q in t.queries:
                if q.kind not in ("quantile", "windowed_quantile"):
                    continue
                floor = quantile_rank_error_bound(q.capacity)
                _require(floor <= target,
                         f"tenant {t.name!r} query {q.name!r}: a capacity-"
                         f"{q.capacity} quantile sketch bottoms out at rank "
                         f"error {floor:.4f} over the planning horizon — "
                         f"above budget.target_rel_error={target}; the "
                         f"error-budget controller could never settle. "
                         f"Raise the sketch capacity or relax the target.")
