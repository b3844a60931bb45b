"""The paper's own workload: the hierarchical stream-analytics driver.

The port's counterpart of ``repro.launch.analytics``. It builds the §V
testbed (8 sources → 4 → 2 → 1 root) from one ``PipelineSpec``, streams
synthetic sub-streams through it and reports windowed SUM/MEAN with ±2σ
bounds, accuracy against the exact sum, throughput, per-hop bandwidth
and a modelled end-to-end latency. The ``level`` and ``loop`` engines
drive ``core.tree.HostTree`` tick by tick; ``scan`` drives
``repro_torch.compile`` an epoch at a time. Everything runs on the CUDA
card unless ``--device cpu`` (``device="cpu"``) is asked for.

Latency model (Fig. 9/10): the testbed's WAN follows §V-A — RTTs of
20/40/80 ms between layers, 1 Gbps links, 16 B/item. An item's
end-to-end latency is the window wait (half an interval per level on
average) + the measured per-node processing time per interval + Σ over
hops of (RTT/2 + forwarded bytes / link rate).

    PYTHONPATH=src python -m repro_torch.launch.analytics --dist gaussian \\
        --fraction 0.1 --ticks 20 --engine level --backend pallas
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import api
from repro_torch.api.spec import (BudgetSpec, PipelineSpec, SamplerSpec,
                                  StrataSpec, TelemetrySpec, TenantSpec,
                                  TopologySpec)
from repro_torch.core.tree import HostTree, accumulate_epoch_accounting
from repro_torch.data import stream as S
from repro_torch.obs.trace import span

# §V-A WAN emulation constants.
HOP_RTT_S = (0.020, 0.040, 0.080)   # source→L0, L0→L1, L1→root
LINK_BW = 1e9 / 8                   # 1 Gbps in bytes/s
ITEM_BYTES = 16                     # value + stratum tag + framing

_MESH_NOT_PORTED = ("the SPMD mesh data plane (--mesh, run_spmd_pipeline) "
                    "is not ported yet: ROADMAP.md Queue 1 item 12 ports it "
                    "to torch.distributed")


def default_capacity(specs, num_sources: int = 8, fanin=(4, 2, 1),
                     interval_ticks=None) -> int:
    """Level-0 buffer provisioning for the offered load (Σ rates ×
    sources per node × interval, 35% Poisson slack): level-0 drops carry
    no metadata, so an under-provisioned buffer biases the estimate
    down."""
    per_node_rate = sum(s.rate for s in specs) * num_sources / fanin[0]
    iv0 = (interval_ticks or [1])[0]
    return max(int(1.35 * per_node_rate * iv0) + 256 & ~255, 1024)


def build_spec(specs=None, *, fraction: float, capacity: int | None = None,
               num_strata: int | None = None, num_sources: int = 8,
               fanin=(4, 2, 1), interval_ticks=None,
               allocation: str = "fair", seed: int = 0, mode: str = "whs",
               sampler_backend: str = "topk", queries=None,
               target_rel_error: float | None = None,
               max_fraction: float | None = None, telemetry: bool = False,
               strata=None) -> PipelineSpec:
    """The §V testbed job as one ``PipelineSpec``. ``specs`` (the
    sub-stream mix) sizes the level-0 buffers and sets ``num_strata``;
    ``queries`` is a ``QueryRegistry`` (one ``"default"`` tenant) or a
    sequence of ``TenantSpec``s."""
    if capacity is None:
        capacity = default_capacity(specs, num_sources, fanin,
                                    interval_ticks)
    if num_strata is None:
        num_strata = len(specs)
    if queries is None:
        tenants = ()
    elif isinstance(queries, (list, tuple)):
        tenants = tuple(queries)
    else:
        tenants = (TenantSpec.from_registry("default", queries),)
    return PipelineSpec(
        topology=TopologySpec(fanin=tuple(fanin), capacity=capacity,
                              interval_ticks=(tuple(interval_ticks)
                                              if interval_ticks else None),
                              num_strata=num_strata),
        sampler=SamplerSpec(mode=mode, backend=sampler_backend,
                            allocation=allocation, fraction=fraction),
        tenants=tenants,
        budget=BudgetSpec(max_fraction=max_fraction,
                          target_rel_error=target_rel_error),
        seed=seed, telemetry=TelemetrySpec(enabled=telemetry),
        strata=strata if strata is not None else StrataSpec())


def _window_rel_error(w: dict, plan=None) -> float:
    """The measured relative ±2σ error of one root window, the signal
    the controller reads: with a plan the worst CLT (sum/mean) query's
    relative bound, otherwise the built-in windowed SUM's."""
    rels = []
    if plan is not None and "answers" in w:
        for _, (off, _, kind) in plan.layout().items():
            if kind in ("sum", "mean"):
                est = abs(float(w["answers"][off]))
                rels.append(float(w["bounds"][off]) / max(est, 1e-9))
    if not rels:
        est = abs(w["sum"])
        rels = [2.0 * float(np.sqrt(max(w["sum_var"], 0.0)))
                / max(est, 1e-9)]
    return max(rels)


def build_tree(num_strata: int, capacity: int, fraction: float,
               fanin=(4, 2, 1), interval_ticks=None, allocation="fair",
               seed: int = 0, mode: str = "whs", engine: str = "level",
               sampler_backend: str = "topk", queries=None,
               max_fraction: float | None = None,
               device="cuda") -> HostTree:
    """A ``HostTree`` from keyword arguments, through ``build_spec`` and
    ``HostTree.from_spec``."""
    spec = build_spec(fraction=fraction, capacity=capacity,
                      num_strata=num_strata, fanin=fanin,
                      interval_ticks=interval_ticks, allocation=allocation,
                      seed=seed, mode=mode, sampler_backend=sampler_backend,
                      queries=queries, max_fraction=max_fraction)
    return HostTree.from_spec(spec, engine=engine, device=device)


class _CompiledDriver:
    """``run_pipeline``'s scan-engine executor: drives a
    ``repro_torch.api.CompiledPipeline`` with ``HostTree``'s accounting
    surface (``results``, ``items_*``, ``level_time_s``,
    ``dispatch_count``). An epoch's wall time is apportioned to levels by
    their buffer slots (``accumulate_epoch_accounting``)."""

    def __init__(self, pipe: "api.CompiledPipeline"):
        self.pipe = pipe
        self.state = pipe.init()
        self.plan = pipe.plan
        self.fanin = list(pipe.fanin)
        self.capacities = list(pipe.capacities)
        self.sample_sizes = list(pipe.sample_sizes)
        self.max_sample_sizes = list(pipe.max_sample_sizes)
        self._key = pipe.default_key
        self.results: list[dict] = []
        self.items_ingested = 0
        self.items_forwarded = [0] * len(self.fanin)
        self.level_time_s = [0.0] * len(self.fanin)
        self.dispatch_count = 0

    def run_epoch(self, t0: int, values, strata, counts, offered=None):
        t_start = time.perf_counter()
        with span("epoch_dispatch", t0=t0, ticks=int(np.shape(counts)[0])):
            self.state, wa = self.pipe.run_epoch(
                self.state, self._key, values, strata, counts,
                budgets=self.sample_sizes)
        with span("block_until_ready"):
            rows = self.pipe.rows(wa)             # device→host read
            n_fwd = wa.n_forwarded.cpu().numpy()
        wall = time.perf_counter() - t_start
        accumulate_epoch_accounting(self, wall, counts, offered, n_fwd)
        self.results.extend(rows)

    def reset_query_state(self) -> None:
        self.state = self.pipe.reset_queries(self.state)

    def set_sample_sizes(self, sizes) -> None:
        self.sample_sizes = self.pipe.clamp_budgets(sizes)


def run_pipeline(specs, *, fraction: float = 0.1, ticks: int,
                 capacity: int | None = None, num_sources: int = 8,
                 fanin=(4, 2, 1), interval_ticks=None,
                 allocation: str = "fair", seed: int = 0, mode: str = "whs",
                 engine: str = "level", sampler_backend: str = "topk",
                 warmup_ticks: int = 0, epoch_ticks: int | None = None,
                 queries=None, target_rel_error: float | None = None,
                 max_fraction: float | None = None,
                 pipeline_spec: PipelineSpec | None = None,
                 return_stream: bool = False, telemetry: bool = False,
                 strata=None, device="cuda"):
    """Stream → tree → per-window results and ground truth, as a dict
    with the reference's keys plus ``n_sampled`` (the items each root
    window kept, in order).

    ``warmup_ticks`` ticks run first (the kernels' first launch, caches)
    and are excluded from the clocks and the accuracy accounting. The
    ``scan`` engine runs epochs of ``epoch_ticks`` (default
    ``min(ticks, 64)``), its warmup one whole epoch, and rounds ``ticks``
    up to whole epochs. ``queries`` registers standing queries answered
    every window; ``target_rel_error`` closes the §IV-B loop (a
    ``BudgetController``, or a ``WorstTenantArbiter`` with several
    tenants, moves the per-level budgets within ``[min_size,
    capacity·max_fraction]``; ``max_fraction`` defaults to 1.0 then).
    ``pipeline_spec`` gives the whole job as one spec instead of the
    keywords it covers. ``strata`` with ``adaptive=True`` runs the
    ``StratumManager`` between epochs (scan engine). ``return_stream``
    also returns the raw ingested stream.
    """
    if pipeline_spec is None:
        if target_rel_error is not None:
            if mode != "whs":
                raise ValueError("the error-budget loop drives WHS budgets")
            max_fraction = 1.0 if max_fraction is None else max_fraction
        pipeline_spec = build_spec(
            specs, fraction=fraction, capacity=capacity,
            num_sources=num_sources, fanin=fanin,
            interval_ticks=interval_ticks, allocation=allocation, seed=seed,
            mode=mode, sampler_backend=sampler_backend, queries=queries,
            target_rel_error=target_rel_error, max_fraction=max_fraction,
            telemetry=telemetry, strata=strata)
    mode = pipeline_spec.sampler.mode
    fraction = pipeline_spec.sampler.fraction
    sampler_backend = pipeline_spec.sampler.backend
    interval_ticks = (list(pipeline_spec.topology.interval_ticks)
                      if pipeline_spec.topology.interval_ticks else None)
    target_rel_error = pipeline_spec.budget.target_rel_error
    if engine == "scan":
        tree = _CompiledDriver(api.compile(pipeline_spec, device=device))
    else:
        if pipeline_spec.strata.adaptive:
            raise ValueError("adaptive stratification rides the scan "
                             "engine's route table: use engine='scan'")
        tree = HostTree.from_spec(pipeline_spec, engine=engine,
                                  device=device)
    manager = None
    if pipeline_spec.strata.adaptive:
        from repro_torch import strata as strata_mod

        manager = strata_mod.StratumManager(
            tree.state.tree.route.cpu().numpy(),
            pipeline_spec.topology.num_strata,
            split_occupancy=pipeline_spec.strata.split_occupancy,
            merge_occupancy=pipeline_spec.strata.merge_occupancy)
    sources = [S.StreamSource(specs, seed=pipeline_spec.seed * 977 + i)
               for i in range(num_sources)]
    controller = None
    trajectory: list[dict] = []
    if target_rel_error is not None:
        from repro_torch.runtime.budget import (BudgetConfig,
                                                BudgetController,
                                                WorstTenantArbiter)

        cfg = BudgetConfig(min_size=pipeline_spec.budget.min_size,
                           max_size=int(tree.max_sample_sizes[0]),
                           target_rel_error=target_rel_error,
                           kp=pipeline_spec.budget.kp,
                           ki=pipeline_spec.budget.ki)
        if len(pipeline_spec.tenants) > 1:
            controller = WorstTenantArbiter(
                cfg, initial_size=int(tree.sample_sizes[0]))
        else:
            controller = BudgetController(
                cfg, initial_size=int(tree.sample_sizes[0]))
    # The raw stream is collected only when asked for: it is O(items) of
    # host memory.
    stream_v: list[np.ndarray] = []
    stream_s: list[np.ndarray] = []

    def _feedback(new_windows: list[dict], step: int) -> None:
        """Feed the controller the freshest measured relative ±2σ error
        and move every level's budget (§IV-B); with several tenants the
        worst-off tenant drives it, split across levels by their
        variance shares."""
        if controller is None or not new_windows:
            return
        if hasattr(controller, "last_tenant"):     # WorstTenantArbiter
            from repro_torch.runtime.budget import (
                aggregate_tenant_rel_errors, level_error_shares)

            per = aggregate_tenant_rel_errors(tree.plan, new_windows)
            ins = [tree.items_ingested] + list(tree.items_forwarded[:-1])
            shares = level_error_shares(ins, tree.items_forwarded)
            sizes = controller.update_levels(per, shares)
            entry = dict(step=step, rel_error=max(per.values() or [0.0]),
                         size=max(sizes), sizes=list(sizes),
                         level_shares=[round(float(s), 6) for s in shares],
                         tenant=controller.last_tenant,
                         tenant_rel_errors=per)
        else:
            rels = [_window_rel_error(w, tree.plan) for w in new_windows]
            rel = float(np.mean([r for r in rels if np.isfinite(r)]
                                or [0.0]))
            size = controller.update(rel_error=rel)
            sizes = [size] * len(tree.fanin)
            entry = dict(step=step, rel_error=rel, size=size)
        tree.set_sample_sizes(sizes)
        trajectory.append(entry)

    if engine == "scan":
        epoch_t = min(epoch_ticks or 64, ticks)
        n_epochs = -(-ticks // epoch_t)
        width = tree.capacities[0]
        t0_tick = 1
        if warmup_ticks > 0:       # one whole epoch
            wb = S.batch_ingest(sources, epoch_t, tree.fanin[0], width)
            tree.run_epoch(t0_tick, wb.values, wb.strata, wb.counts,
                           offered=wb.offered)
            t0_tick += epoch_t
    else:
        for t in range(1, warmup_ticks + 1):
            for i, src in enumerate(sources):
                vals, strs = src.tick()
                tree.ingest(i % tree.fanin[0], vals, strs)
            tree.tick(t)
    # Accounting (sketch state and telemetry included) covers only the
    # measured ticks.
    tree.reset_query_state()
    if engine == "scan":
        from repro_torch.obs import telemetry as obs_telemetry

        tree.state = obs_telemetry.reset(tree.state)
    tree.results.clear()
    tree.items_ingested = 0
    tree.items_forwarded = [0] * len(tree.fanin)
    tree.level_time_s = [0.0] * len(tree.fanin)
    tree.dispatch_count = 0

    exact_sum = 0.0
    exact_cnt = 0
    ingest_truncation_warned = False
    t0 = time.time()
    if engine == "scan":
        for e in range(n_epochs):
            with span("ingest", epoch=e):
                b = S.batch_ingest(sources, epoch_t, tree.fanin[0], width)
            exact_sum += b.exact_sum
            exact_cnt += b.exact_count
            dropped = int((b.offered - b.counts).sum())
            if dropped and not ingest_truncation_warned:
                # Level-0 drops carry no metadata: every estimate biases
                # low with no error signal.
                import warnings

                warnings.warn(
                    f"level-0 ingest truncated {dropped} items in epoch "
                    f"{e} (capacity {width} per node/tick is below the "
                    f"offered load) — estimates will bias low; rebuild "
                    f"the PipelineSpec for the actual source count and "
                    f"rates", RuntimeWarning, stacklevel=2)
                ingest_truncation_warned = True
            if return_stream:
                for tt in range(epoch_t):
                    for node in range(tree.fanin[0]):
                        c = int(b.counts[tt, node])
                        stream_v.append(b.values[tt, node, :c])
                        stream_s.append(b.strata[tt, node, :c])
            n_before = len(tree.results)
            tree.run_epoch(t0_tick + e * epoch_t, b.values, b.strata,
                           b.counts, offered=b.offered)
            _feedback(tree.results[n_before:], step=e)
            if manager is not None and e + 1 < n_epochs:
                # Epoch boundary: this epoch's per-key arrivals into the
                # manager; a split or merge is a same-shape edit of the
                # route table and the Eq. 9 metadata.
                from repro_torch import strata as strata_mod

                pos = np.arange(np.shape(b.strata)[-1])[None, None, :]
                live = pos < np.asarray(b.counts)[..., None]
                keys = np.asarray(b.strata)[live]
                kc = np.bincount(keys, minlength=manager.num_keys)
                km = np.bincount(keys, minlength=manager.num_keys,
                                 weights=np.abs(np.asarray(b.values)[live]))
                manager.observe(kc, km)
                ops = manager.maybe_adapt()
                if ops:
                    tree.state = tree.state._replace(
                        tree=strata_mod.remap_tree_state(
                            tree.state.tree, ops, manager.route))
    else:
        for t in range(warmup_ticks + 1, warmup_ticks + ticks + 1):
            for i, src in enumerate(sources):
                vals, strs = src.tick()
                exact_sum += float(vals.sum())
                exact_cnt += len(vals)
                if return_stream:
                    stream_v.append(vals)
                    stream_s.append(strs)
                tree.ingest(i % tree.fanin[0], vals, strs)
            n_before = len(tree.results)
            tree.tick(t)
            _feedback(tree.results[n_before:], step=t)
    wall = time.time() - t0

    approx_sum = float(sum(r["sum"] for r in tree.results))
    bound = 2 * float(np.sqrt(sum(r["sum_var"] for r in tree.results)))
    acc_loss = abs(approx_sum - exact_sum) / max(abs(exact_sum), 1e-9)

    # Latency and pipeline-throughput model (module docstring): in the
    # testbed the nodes are separate machines, so per-item path cost and
    # the sustained rate are per-node quantities.
    n_windows = max(len(tree.results), 1)
    it = interval_ticks or [1] * len(tree.fanin)
    window_wait = sum(iv / 2.0 for iv in it)          # in ticks
    node_time = [lt / max(n, 1)
                 for lt, n in zip(tree.level_time_s, tree.fanin)]
    proc = sum(nt / n_windows for nt in node_time)
    fwd = [tree.items_ingested] + tree.items_forwarded[:-1]
    transfer = sum(
        HOP_RTT_S[min(h, len(HOP_RTT_S) - 1)] / 2.0
        + (fwd[h] / n_windows
           / max(tree.fanin[min(h, len(tree.fanin) - 1)], 1))
        * ITEM_BYTES / LINK_BW
        for h in range(len(tree.fanin)))
    latency = proc + transfer
    # Sustained rate = the slowest stage per node.
    bottleneck = max(nt / max(wall, 1e-9) for nt in node_time)
    pipeline_tp = (exact_cnt / max(wall, 1e-9)) / max(bottleneck, 1e-9)
    extras = {}
    if tree.plan is not None:
        extras["query_layout"] = {
            n: dict(offset=o, width=wd, kind=k)
            for n, (o, wd, k) in tree.plan.layout().items()}
        extras["windows_answers"] = [r["answers"] for r in tree.results
                                     if "answers" in r]
        extras["windows_bounds"] = [r["bounds"] for r in tree.results
                                    if "bounds" in r]
    if controller is not None:
        extras["controller"] = trajectory
        extras["final_sample_sizes"] = list(tree.sample_sizes)
    if manager is not None:
        import dataclasses as _dc

        extras["strata_ops"] = [_dc.asdict(op) for op in manager.ops_log]
        extras["strata_route"] = tree.state.tree.route.cpu().tolist()
    if engine == "scan" and tree.pipe.telemetry_enabled:
        from repro_torch.obs.metrics import metrics_text
        from repro_torch.obs.telemetry import snapshot, tenant_rel_bounds
        from repro_torch.obs.trace import get_tracer

        snap = snapshot(tree.state)
        snap["slot_rel_bound_mean"] = np.asarray(
            snap["slot_rel_bound_mean"]).tolist()
        snap["tenant_rel_bounds"] = tenant_rel_bounds(tree.pipe, tree.state)
        extras["telemetry"] = snap
        extras["metrics"] = metrics_text(
            pipeline=tree.pipe, state=tree.state, tracer=get_tracer(),
            controller=controller)
    if return_stream:
        extras["stream_values"] = (np.concatenate(stream_v) if stream_v
                                   else np.zeros(0, np.float32))
        extras["stream_strata"] = (np.concatenate(stream_s) if stream_s
                                   else np.zeros(0, np.int32))
    return {
        **extras,
        "fraction": fraction,
        "mode": mode,
        "engine": engine,
        "sampler_backend": sampler_backend,
        "dispatches": tree.dispatch_count,
        "approx_sum": approx_sum,
        "exact_sum": exact_sum,
        "bound_2sigma": bound,
        "accuracy_loss": acc_loss,
        "within_2sigma": abs(approx_sum - exact_sum) <= bound,
        "items_ingested": tree.items_ingested,
        "items_forwarded": tree.items_forwarded,
        "bandwidth_fraction": (tree.items_forwarded[0] /
                               max(tree.items_ingested, 1)),
        "wall_s": wall,
        "throughput_items_s": exact_cnt / max(wall, 1e-9),
        "pipeline_items_s": pipeline_tp,
        "level_time_s": list(tree.level_time_s),
        "latency_s": latency,
        "latency_window_ticks": window_wait,
        "windows": len(tree.results),
        # per root window, in order: what the card and the CPU compare
        "n_sampled": [r["n_sampled"] for r in tree.results],
    }


def run_spmd_pipeline(*args, **kwargs):
    """The §III-E pod-scale data plane: not ported yet (raises)."""
    raise ValueError(_MESH_NOT_PORTED)


def stream_specs(dist: str):
    """The sub-stream mix of one ``--dist`` name."""
    return {
        "gaussian": S.paper_gaussian,
        "poisson": S.paper_poisson,
        "poisson-skewed": lambda: S.paper_poisson(
            rates=tuple(8000 * s for s in S.SKEW_SHARES), skewed=True),
        "taxi": S.taxi_like,
        "pollution": S.pollution_like,
    }[dist]()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dist", default="gaussian",
                    choices=["gaussian", "poisson", "poisson-skewed", "taxi",
                             "pollution"])
    ap.add_argument("--fraction", type=float, default=0.1)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--allocation", default="fair",
                    choices=["fair", "proportional", "neyman"],
                    help="per-stratum reservoir split: fair = equal "
                         "water-filled shares, proportional = largest-"
                         "remainder by arrival count, neyman = count×std "
                         "optimal (the adaptive arm of Fig. 11c)")
    ap.add_argument("--adaptive-strata", action="store_true",
                    help="scan engine: split hot / merge starved strata "
                         "at epoch boundaries via the key→stratum route "
                         "table (repro_torch.strata), a same-shape state "
                         "edit")
    ap.add_argument("--mode", default="whs", choices=["whs", "srs"])
    ap.add_argument("--engine", default="level",
                    choices=["level", "loop", "scan"],
                    help="level = one step per level per tick; loop = one "
                         "per node per tick; scan = the whole tree on the "
                         "device, one epoch of ticks per call")
    ap.add_argument("--epoch-ticks", type=int, default=None,
                    help="scan engine: ticks per epoch (default: "
                         "min(ticks, 64))")
    ap.add_argument("--backend", default="topk",
                    choices=["argsort", "topk", "pallas", "pallas_fused"],
                    help="sampler selection backend: argsort = lexsort "
                         "reference, topk = dense partial-selection "
                         "thresholds, pallas = thresholds + the "
                         "sample_mask kernel, pallas_fused = the "
                         "fused_level_tick kernel")
    ap.add_argument("--queries", default=None, metavar="TOKENS",
                    help="standing queries answered at the root every "
                         "window, e.g. "
                         "'sum,count,mean,hist:0:120000:32,q:0.5:0.9:0.99,hh'"
                         " (see repro_torch.query.registry)")
    ap.add_argument("--target-rel-error", type=float, default=None,
                    help="close the §IV-B loop: adapt per-level sample "
                         "budgets online until the measured relative ±2σ "
                         "error meets this target")
    ap.add_argument("--max-fraction", type=float, default=None,
                    help="budget ceiling for the error-budget controller "
                         "(fraction of window capacity; default 1.0)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="the §III-E SPMD data plane on N devices: not "
                         "ported yet (ROADMAP.md Queue 1 item 12)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the result report to PATH")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable the observability plane "
                         "(repro_torch.obs): the report gains a "
                         "'telemetry' snapshot and a Prometheus-text "
                         "'metrics' block (scan engine)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the host span tracer's Chrome/Perfetto "
                         "trace.json to PATH")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the pipeline runs (default: the CUDA card; "
                         "it raises without one)")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        raise ValueError(_MESH_NOT_PORTED)

    specs = stream_specs(args.dist)
    registry = None
    if args.queries:
        from repro_torch.query.registry import QueryRegistry

        registry = QueryRegistry.from_tokens(args.queries)
    if args.telemetry and args.engine != "scan":
        # telemetry leaves live in the compiled pipeline's state
        args.engine = "scan"
    strata_spec = None
    if args.adaptive_strata:
        args.engine = "scan"   # the route table lives in the scan state
        strata_spec = StrataSpec(num_keys=len(specs), adaptive=True)
    r = run_pipeline(specs, fraction=args.fraction, ticks=args.ticks,
                     allocation=args.allocation, mode=args.mode,
                     engine=args.engine, sampler_backend=args.backend,
                     warmup_ticks=2, epoch_ticks=args.epoch_ticks,
                     queries=registry,
                     target_rel_error=args.target_rel_error,
                     max_fraction=args.max_fraction,
                     telemetry=args.telemetry, strata=strata_spec,
                     device=args.device)
    print(f"dist={args.dist} mode={args.mode} engine={r['engine']} "
          f"backend={args.backend} fraction={r['fraction']:.0%}")
    print(f"  SUM ≈ {r['approx_sum']:.4e} ± {r['bound_2sigma']:.2e} "
          f"(exact {r['exact_sum']:.4e}; within 2σ: {r['within_2sigma']})")
    print(f"  accuracy loss  {r['accuracy_loss']:.5%}")
    if "strata_ops" in r:
        kinds = [op["kind"] for op in r["strata_ops"]]
        print(f"  strata         {kinds.count('split')} splits, "
              f"{kinds.count('merge')} merges; route {r['strata_route']}")
    print(f"  bandwidth kept {r['bandwidth_fraction']:.1%} of ingested "
          f"items")
    print(f"  throughput     {r['throughput_items_s']:.0f} items/s "
          f"({r['items_ingested']} items, {r['windows']} windows, "
          f"{r['dispatches']} step dispatches) on {args.device}")
    print(f"  latency        {r['latency_s'] * 1e3:.1f} ms/window "
          f"(+{r['latency_window_ticks']:.1f} tick window wait)")
    if registry is not None and r.get("windows_answers"):
        last_a, last_b = r["windows_answers"][-1], r["windows_bounds"][-1]
        print("  standing queries (last window, ± bound):")
        for name, lay in r["query_layout"].items():
            o, wd = lay["offset"], lay["width"]
            a = ", ".join(f"{v:.4g}" for v in last_a[o:o + min(wd, 6)])
            b = ", ".join(f"{v:.3g}" for v in last_b[o:o + min(wd, 6)])
            more = " …" if wd > 6 else ""
            print(f"    {name:<12} [{a}{more}] ± [{b}{more}]")
    if r.get("controller"):
        tr = r["controller"]
        print(f"  error-budget controller: size {tr[0]['size']}→"
              f"{tr[-1]['size']} over {len(tr)} updates "
              f"(rel err {tr[0]['rel_error']:.4f}→{tr[-1]['rel_error']:.4f},"
              f" target {args.target_rel_error})")
    if r.get("telemetry"):
        tel = r["telemetry"]
        fr = ", ".join(f"L{i}:{lv['effective_fraction']:.3f}"
                       for i, lv in enumerate(tel["levels"]))
        print(f"  telemetry      {tel['windows']} windows, realized ±2σ "
              f"{tel['bound_2sigma']:.3e} "
              f"(rel {tel['rel_bound_2sigma']:.4f}); eff fraction {fr}")
    if args.trace:
        from repro_torch.obs.trace import get_tracer

        get_tracer().save(args.trace)
        print(f"  wrote {args.trace}")
    if args.json:
        import json
        import pathlib

        payload = {k: v for k, v in r.items()
                   if k not in ("windows_answers", "windows_bounds")}
        pathlib.Path(args.json).write_text(
            json.dumps(payload, indent=1, default=str))
        print(f"  wrote {args.json}")
    return r


if __name__ == "__main__":
    main()
