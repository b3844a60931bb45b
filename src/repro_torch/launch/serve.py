"""Serving launcher: the ApproxIoT telemetry plane over an inference
fleet, in two modes — the port of ``repro.launch.serve``.

**One-shot** (default): batched prefill and greedy decode of a model of
the zoo (random weights from a seed), then every serving batch's
per-request latency records become one tick of ingest into the emulated
edge hierarchy (2 edge aggregators → 1 root) on a compiled pipeline
(``repro_torch.compile``), where the dashboard's standing queries
(request count → QPS, mean latency, p50/p99 via the quantile sketch) are
a query tenant answered at the root every window. ``--hot-admit`` admits
an ``slo`` tenant half way through the epoch (a state edit), then
retires and re-admits it, and prints what the program cache built.

**Continuous** (``--serve-loop``): the same telemetry plane behind the
always-on ``repro_torch.serve.StreamingExecutor`` — subscribed sources
feed bounded per-shard queues (``--backpressure`` policy), ingest is
double-buffered, and every root window publishes straggler-tolerantly:
late shards yield *partial* answers with Eq. 9-widened bounds and their
data folds into the next window. The loop registry adds the recency
queries (sliding-window quantiles, decayed heavy hitters); ``stop()``
drains the queues clean. ``--inject-straggler`` holds one edge shard
back for an epoch to show the partial-window path.

``--mesh N`` runs the one-shot telemetry plane on N ranks of a
``torch.distributed`` mesh instead (``repro_torch.compile(spec,
mesh=...)``): the model serves in this process, then every rank samples
its shard of each batch's records and the dashboard tenant answers from
merged sketch summaries; no raw record crosses a rank. NCCL runs one
card a rank, gloo (``--mesh-backend gloo``) CPU ranks or ranks sharing
one card. Everything runs on the CUDA card unless ``--device cpu`` is
asked for.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --requests 64 --decode-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --mesh 2 \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --serve-loop \\
        --duration 5 --inject-straggler --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs import registry
from repro_torch.data import stream as S
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_data_mesh, spawn_ranks
from repro_torch.models import model as M
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs.metrics import metrics_text
from repro_torch.obs.trace import get_tracer, span
from repro_torch.optim import train_step
from repro_torch.query.registry import QueryRegistry

NUM_CLASSES = 4          # request classes = telemetry strata
EDGE_NODES = 2           # telemetry aggregators in front of the root

def dashboard_registry() -> QueryRegistry:
    """The dashboard's standing queries, registered once."""
    return (QueryRegistry()
            .register_count("requests")
            .register_sum("latency_total_ms")
            .register_mean("latency_mean_ms")
            .register_quantile("latency_q_ms", qs=(0.5, 0.99), capacity=256))


def serve_registry(window: int = 4) -> QueryRegistry:
    """The continuous dashboard: everything the one-shot dashboard
    answers plus the serve plane's recency queries — "last ``window``
    windows" latency quantiles and exponentially decayed hot-class
    counts."""
    return (dashboard_registry()
            .register_windowed_quantile("latency_q_recent_ms",
                                        qs=(0.5, 0.99), capacity=128,
                                        window=window)
            .register_decayed_heavy_hitters("hot_latency_keys", k=4,
                                            width=256, decay=0.8))


def telemetry_spec(capacity: int, fraction: float, seed: int = 0,
                   telemetry: bool = False,
                   registry_fn=dashboard_registry) -> api.PipelineSpec:
    """The serving fleet's telemetry plane as one declarative spec:
    per-request records → 2 edge aggregators → 1 datacenter root, the
    dashboard (``registry_fn()``) as a query tenant on the shared tree."""
    return api.PipelineSpec(
        topology=api.TopologySpec(fanin=(EDGE_NODES, 1), capacity=capacity,
                                  num_strata=NUM_CLASSES),
        sampler=api.SamplerSpec(mode="whs", backend="topk",
                                fraction=fraction),
        tenants=(registry_fn().as_tenant("dashboard"),),
        telemetry=api.TelemetrySpec(enabled=telemetry),
        seed=seed,
    )


def serve_batch(cfg, params, toks: torch.Tensor,
                decode_len: int) -> torch.Tensor:
    """One serving batch, the reference's loop: a fresh cache of
    ``prompt_len + decode_len`` slots, the prompt teacher-forced through
    the decode step at positions ``0 … prompt_len − 2``, then greedy
    decode from position ``prompt_len − 1`` to the end. As in the
    reference, the first decoded input is the prompt's FIRST token
    (``toks[:, :1]``), not its last. ``toks`` int ``[B, prompt_len]`` on
    the model's device → the greedy tokens ``[B, decode_len + 1]``
    (``argmax``, first maximum). Every family's cache serves the same
    way; encdec decodes against ``init_cache``'s zero cross K/V, as the
    reference's CLI does."""
    decode = train_step.make_decode_step(cfg)
    b, prompt_len = toks.shape
    max_len = prompt_len + decode_len
    cache = M.init_cache(cfg, b, max_len, device=toks.device)
    tok = toks[:, :1]
    for pos in range(prompt_len - 1):
        _, cache = decode(params, cache, toks[:, pos:pos + 1], pos)
    out = []
    for pos in range(prompt_len - 1, max_len):
        logits, cache = decode(params, cache, tok, pos)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=registry.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-len", type=int, default=16)
    ap.add_argument("--telemetry-fraction", type=float, default=0.25)
    ap.add_argument("--hot-admit", action="store_true",
                    help="demo tenant churn on the live telemetry plane: "
                         "serve half the epoch with the dashboard tenant "
                         "only, hot-admit an 'slo' tenant mid-stream (a "
                         "state edit, not a recompile), answer its queries "
                         "over the second half, then retire + re-admit it "
                         "and print what the program cache built")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="run the telemetry plane on N ranks of a 'data' "
                         "mesh (repro_torch.compile(spec, mesh=...)): each "
                         "rank samples its shard of every batch's records "
                         "and the dashboard tenant answers from merged "
                         "sketch summaries — no raw record crosses ranks")
    ap.add_argument("--mesh-backend", default=None, choices=["nccl", "gloo"],
                    help="the mesh's collective backend: nccl (one card "
                         "a rank; the default on cuda) or gloo (CPU "
                         "ranks, the default on cpu, or ranks sharing "
                         "one card)")
    ap.add_argument("--telemetry", action="store_true",
                    help="carry EpochTelemetry counters inside the "
                         "pipeline state (repro_torch.obs) — sample state "
                         "and dashboard answers stay bit-identical")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="write a Prometheus-text metrics snapshot of the "
                         "telemetry plane to PATH at exit (implies "
                         "--telemetry)")
    ap.add_argument("--metrics-every", type=int, default=None, metavar="N",
                    help="print a metrics snapshot to stdout every N "
                         "telemetry windows during the epoch (implies "
                         "--telemetry)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the host span tracer's Chrome/Perfetto "
                         "trace.json to PATH")
    ap.add_argument("--serve-loop", action="store_true",
                    help="continuous mode: run the telemetry plane behind "
                         "the always-on repro_torch.serve.StreamingExecutor "
                         "(bounded queues, double-buffered ingest, "
                         "straggler-tolerant windows) instead of one "
                         "one-shot epoch; --requests/--batch set the "
                         "epoch length in ticks")
    ap.add_argument("--duration", type=float, default=5.0, metavar="SEC",
                    help="serve-loop: wall-clock seconds to pump before "
                         "draining")
    ap.add_argument("--tick-interval", type=float, default=0.02,
                    metavar="SEC",
                    help="serve-loop: target seconds between pumps")
    ap.add_argument("--backpressure", default="block",
                    choices=("block", "drop_oldest", "degrade"),
                    help="serve-loop: bounded-queue policy when ingest "
                         "outruns the device")
    ap.add_argument("--queue-capacity", type=int, default=4096,
                    help="serve-loop: per-shard bounded queue capacity")
    ap.add_argument("--inject-straggler", action="store_true",
                    help="serve-loop: hold one edge shard's deliveries "
                         "for a full epoch so partial windows with "
                         "widened bounds publish, then fold the late "
                         "data into the next window")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and the telemetry plane run "
                         "(default: the CUDA card; it raises without one)")
    args = ap.parse_args(argv)
    if args.metrics_dump or args.metrics_every:
        args.telemetry = True

    n_batches = args.requests // args.batch
    if n_batches == 0:
        ap.error(f"--requests {args.requests} < --batch {args.batch}: "
                 f"no serving batch would run (requests are served in "
                 f"whole batches)")
    with get_tracer().on(bool(args.trace or args.telemetry)):
        return _serve(args, n_batches)


def _serve(args, n_batches: int):
    """``main``'s run of parsed arguments: the report, printed."""
    dev = resolve_device(args.device)
    if args.serve_loop:
        return _serve_loop(args, dev)
    cfg = registry.get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()

    params = M.init_params(cfg, seed=0, device=dev)

    rng = np.random.default_rng(0)
    tick_records: list[tuple[np.ndarray, np.ndarray]] = []
    t_all = time.time()
    for _ in range(n_batches):
        toks = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
        t0 = time.time()
        serve_batch(cfg, params, torch.as_tensor(toks, device=dev),
                    args.decode_len)
        _sync(dev)
        dt = (time.time() - t0) / args.batch
        # one tick of telemetry per serving batch: ms per request,
        # stratified by request class
        tick_records.append((
            np.full((args.batch,), dt * 1000, np.float32),
            rng.integers(0, NUM_CLASSES, args.batch).astype(np.int32)))
    wall = time.time() - t_all

    # ---- telemetry through the pipeline ----------------------------------
    # Each serving batch is one tick into the 2→1 hierarchy; the pipeline
    # samples at every hop and the dashboard tenant's standing queries are
    # answered at the root each window.
    capacity = max(64, args.batch)
    m = sum(len(v) for v, _ in tick_records)
    # With --mesh the same spec lowers onto the §III-E data plane instead:
    # every rank samples its shard of each batch's records and the
    # dashboard answers from merged sketch summaries.
    if args.mesh:
        backend = args.mesh_backend or (
            "nccl" if dev.type == "cuda" else "gloo")
        job = dict(records=tick_records, capacity=capacity, n=args.mesh,
                   fraction=args.telemetry_fraction,
                   telemetry=args.telemetry, device=args.device,
                   backend=backend, metrics=bool(args.metrics_dump))
        if args.mesh == 1:
            plane = _mesh_plane(job)
        else:
            # by the module's name: under ``python -m`` this is __main__
            from repro_torch.launch.serve import _mesh_plane as rank_fn

            plane = spawn_ranks(rank_fn, args.mesh, args=(job,),
                                device=args.device, backend=backend)[0]
        rows = plane["rows"]
        row_pipes = [_PlaneView(plane["layout"])] * len(rows)
        n_queries, snap = plane["k"], plane["snapshot"]
    else:
        pipe = api.compile(telemetry_spec(capacity, args.telemetry_fraction,
                                          telemetry=args.telemetry), device=dev)
        state = pipe.init()
        with span("ingest", ticks=len(tick_records)):
            batch = S.ticks_to_ingest(tick_records, n_nodes=EDGE_NODES,
                                      width=capacity)
        if args.hot_admit:
            from repro_torch.api.pipeline import program_cache_stats

            h = max(1, len(tick_records) // 2)
            with span("epoch_dispatch", ticks=h):
                state, wa_a = pipe.run_epoch(state, pipe.default_key,
                                             batch.values[:h], batch.strata[:h],
                                             batch.counts[:h])
            rows_a = pipe.rows(wa_a)
            m0 = program_cache_stats()["misses"]
            slo = (QueryRegistry().register_count("n")
                   .register_mean("mean_ms")
                   .register_quantile("p999_ms", qs=(0.999,), capacity=128)
                   .as_tenant("slo"))
            # hot admit: a slot edit on the carried state, answers resume
            # mid-stream; the dashboard tenant's sketches are untouched
            pipe2, state = pipe.admit(state, slo)
            with span("epoch_dispatch", ticks=len(batch.values) - h):
                state, wa_b = pipe2.run_epoch(state, pipe2.default_key,
                                              batch.values[h:], batch.strata[h:],
                                              batch.counts[h:])
            rows_b = pipe2.rows(wa_b)
            m1 = program_cache_stats()["misses"]
            pipe3, state = pipe2.retire(state, "slo")
            pipe4, state = pipe3.admit(state, slo)
            m2 = program_cache_stats()["misses"]
            slo_n = float(sum(pipe2.answer(r["answers"], "n", tenant="slo")[0]
                              for r in rows_b))
            p999 = float(pipe2.answer(rows_b[-1]["answers"], "p999_ms",
                                      tenant="slo")[0])
            print(f"hot-admit 'slo' tenant after {h}/{len(tick_records)} "
                  f"ticks: {len(rows_b)} windows answered mid-stream "
                  f"({slo_n:.0f} requests seen, p99.9 ≈ {p999:.2f} ms)")
            print(f"  churn cost: admit into a new slot group traced "
                  f"{m1 - m0} program(s); retire + re-admit into the warm "
                  f"slot traced {m2 - m1} (plan cache: "
                  f"{program_cache_stats()['hits']} hits)")
            rows = rows_a + rows_b
            row_pipes = [pipe] * len(rows_a) + [pipe2] * len(rows_b)
            pipe = pipe4
        else:
            # --metrics-every N slices the epoch into N-tick chunks and
            # exposes the /metrics surface between them; without it the one
            # chunk is the whole epoch.
            n_ticks = len(batch.values)
            step = max(args.metrics_every or n_ticks, 1)
            rows = []
            for s0 in range(0, n_ticks, step):
                s1 = min(s0 + step, n_ticks)
                with span("epoch_dispatch", ticks=s1 - s0):
                    state, wa = pipe.run_epoch(
                        state, pipe.default_key, batch.values[s0:s1],
                        batch.strata[s0:s1], batch.counts[s0:s1])
                with span("block_until_ready"):
                    _sync(dev)
                rows.extend(pipe.rows(wa))
                if args.metrics_every:
                    print(f"--- metrics after {s1}/{n_ticks} ticks ---")
                    print(metrics_text(pipeline=pipe, state=state,
                                       tracer=get_tracer()))
            row_pipes = [pipe] * len(rows)
        n_queries, snap = pipe.plan.k, obs_telemetry.snapshot(state)
    # rows from before and after a hot admit carry different layouts:
    # answer each row through the pipeline that produced it
    pipe_of = {id(r): p for p, r in zip(row_pipes, rows)}

    def a(name, row):
        return pipe_of[id(row)].answer(row["answers"], name,
                                       tenant="dashboard")

    def bnd(name, row):
        return pipe_of[id(row)].answer(row["bounds"], name,
                                       tenant="dashboard")

    # CLT queries aggregate across windows; the quantile sketch is
    # continuous, so the last window answers over every request served.
    last = rows[-1]
    n_est = float(sum(a("requests", r)[0] for r in rows))
    total_est = float(sum(a("latency_total_ms", r)[0] for r in rows))
    mean_est = total_est / max(n_est, 1e-9)
    mean_bnd = float(max(bnd("latency_mean_ms", r)[0] for r in rows))
    p50, p99 = a("latency_q_ms", last)
    exact_all = np.concatenate([v for v, _ in tick_records])
    exact_mean = float(exact_all.mean())
    n_kept = int(sum(r["n_sampled"] for r in rows))
    plane_name = (f"{args.mesh}-device SPMD mesh (merged sketch summaries)"
                  if args.mesh else f"{EDGE_NODES}→1 hierarchy")
    print(f"served {m} requests in {wall:.1f}s")
    print(f"telemetry plane: {len(rows)} windows through the "
          f"{plane_name}, {n_queries} standing queries, "
          f"1 fused dispatch, {n_kept}/{m} records at the root")
    print(f"  QPS              ≈ {n_est / max(wall, 1e-9):.2f}")
    print(f"  total latency-ms ≈ {total_est:.1f} "
          f"± {float(sum(bnd('latency_total_ms', r)[0] for r in rows)):.1f}"
          f" (2σ)")
    print(f"  mean latency-ms  ≈ {mean_est:.2f} ± {mean_bnd:.2f} "
          f"(exact {exact_mean:.2f})")
    print(f"  p50 / p99 ms     ≈ {float(p50):.2f} / {float(p99):.2f} "
          f"(sketch rank-ε {float(bnd('latency_q_ms', last)[0]):.3f})")
    if snap is not None:
        print(f"  telemetry        {snap['windows']} windows, realized "
              f"±2σ {snap['bound_2sigma']:.3e} "
              f"(rel {snap['rel_bound_2sigma']:.4f})"
              + (f", {snap['merge_bytes']:.0f} sketch bytes merged"
                 if args.mesh else ""))
    if args.metrics_dump:
        text = (plane["metrics"] if args.mesh else
                metrics_text(pipeline=pipe, state=state, tracer=get_tracer()))
        with open(args.metrics_dump, "w") as f:
            f.write(text)
        print(f"  wrote {args.metrics_dump}")
    if args.trace:
        get_tracer().save(args.trace)
        print(f"  wrote {args.trace}")
    return mean_est, exact_mean


class _PlaneView:
    """The mesh pipeline's answer routing as rank 0 reported it: what
    the printing code reads of a pipeline."""

    def __init__(self, layout: dict):
        self.layout = layout

    def answer(self, vec, name: str, tenant: str | None = None):
        o, w, _ = self.layout[name]
        return np.asarray(vec)[..., o:o + w]


def _mesh_plane(job: dict) -> dict:
    """One rank of the one-shot telemetry plane on the mesh: the records
    as one flat batch a tick, split over the ranks; returns the rows and
    what the report prints (the same on every rank)."""
    n = job["n"]
    mesh = make_data_mesh(n, device=job["device"], backend=job["backend"])
    capacity = job["capacity"]
    pipe = api.compile(telemetry_spec(capacity, job["fraction"],
                                      telemetry=job["telemetry"]),
                       mesh=mesh)
    # a rank process reports its spans in its metrics as main's does
    with get_tracer().on(job["telemetry"]):
        records = job["records"]
        with span("ingest", ticks=len(records)):
            flat = S.ticks_to_ingest(records, n_nodes=1, width=capacity)
            batches = S.rows_to_interval_batch(
                flat.values[:, 0], flat.strata[:, 0], flat.counts[:, 0],
                NUM_CLASSES, width=-(-capacity // n) * n)
        state = pipe.init()
        with span("epoch_dispatch", ticks=len(records)):
            state, wa = pipe.run_epoch(state, pipe.default_key, batches)
        with span("block_until_ready"):
            rows = pipe.rows(wa)
        return dict(rows=rows, layout=pipe.query_layout("dashboard"),
                    k=pipe.plan.k, snapshot=obs_telemetry.snapshot(state),
                    metrics=(metrics_text(pipeline=pipe, state=state,
                                          tracer=get_tracer())
                             if job["metrics"] else None))


def _serve_loop(args, dev):
    """Continuous mode: the telemetry plane behind the streaming executor
    (see the module doc). Returns the executor's final stats."""
    from repro_torch.serve import (LateShardSource, StreamingExecutor,
                                   SyntheticSource)

    epoch_ticks = args.requests // args.batch
    capacity = max(64, args.batch)
    pipe = api.compile(telemetry_spec(capacity, args.telemetry_fraction,
                                      telemetry=args.telemetry,
                                      registry_fn=serve_registry),
                       device=dev)
    # Per-shard synthetic request-latency sources: NUM_CLASSES request
    # classes with distinct latency profiles (ms); class = stratum.
    per_class = max(2, args.batch // (EDGE_NODES * NUM_CLASSES))
    sources = [SyntheticSource(
        shard, specs=[S.SubstreamSpec("gaussian",
                                      (20.0 * 2 ** c, 2.0 * 2 ** c),
                                      per_class)
                      for c in range(NUM_CLASSES)], seed=shard)
        for shard in range(EDGE_NODES)]
    if args.inject_straggler:
        # Hold the last shard's deliveries for one full epoch starting
        # at the second: the affected windows publish partial (widened
        # bounds) and the backlog folds into the following window.
        sources[-1] = LateShardSource(sources[-1], epoch_ticks,
                                      2 * epoch_ticks)
    ex = StreamingExecutor(epoch_ticks=epoch_ticks, width=capacity,
                           queue_capacity=args.queue_capacity,
                           policy=args.backpressure)
    ex.start(pipe, sources)
    t0 = time.time()
    ticks = 0
    with span("serve_loop", duration=args.duration):
        while time.time() - t0 < args.duration:
            tick_t0 = time.time()
            ex.pump()
            ticks += 1
            sleep = args.tick_interval - (time.time() - tick_t0)
            if sleep > 0:
                time.sleep(sleep)
    summary = ex.stop()
    wall = time.time() - t0
    print(f"serve-loop: {ticks} ticks in {wall:.1f}s — "
          f"{summary['epochs']} epochs of {epoch_ticks} ticks, "
          f"backpressure={args.backpressure}"
          + (", straggler injected" if args.inject_straggler else ""))
    print(f"  windows published    {summary['windows_published']} "
          f"({summary['windows_partial']} partial, bounds widened 1/α)")
    print(f"  queue accounting     in {summary['queue_items_in']}, "
          f"dropped {summary['queue_items_dropped']}, deferred "
          f"{summary['queue_deferred']}, high-watermark "
          f"{summary['queue_high_watermark']}, drained to depth "
          f"{max(summary['queue_depth'], default=0)}")
    print(f"  ingest/dispatch overlap {summary['overlap_fraction']:.2f} "
          f"(measured while a device epoch was in flight)")
    print(f"  window latency       p50 {summary['latency_p50'] * 1e3:.1f} "
          f"ms / p99 {summary['latency_p99'] * 1e3:.1f} ms "
          f"(arrival → published answer)")
    if ex.published:
        last = ex.published[-1]
        p50, p99 = last.raw["answers"][
            slice(*_qslice(pipe, "latency_q_ms"))]
        r50, r99 = last.raw["answers"][
            slice(*_qslice(pipe, "latency_q_recent_ms"))]
        print(f"  latency p50/p99 ms   stream-so-far ≈ {float(p50):.1f} / "
              f"{float(p99):.1f}; recent windows ≈ {float(r50):.1f} / "
              f"{float(r99):.1f}")
    snap = obs_telemetry.snapshot(ex.state)
    if snap is not None:
        print(f"  telemetry            {snap['late_shards']} late shards, "
              f"{snap['widened_windows']} widened windows "
              f"(in-graph counters)")
    if args.metrics_dump:
        text = metrics_text(pipeline=pipe, state=ex.state,
                            tracer=get_tracer(), straggler=ex.monitor,
                            executor=ex)
        with open(args.metrics_dump, "w") as f:
            f.write(text)
        print(f"  wrote {args.metrics_dump}")
    if args.trace:
        get_tracer().save(args.trace)
        print(f"  wrote {args.trace}")
    return summary


def _qslice(pipe, name: str) -> tuple[int, int]:
    o, w, _ = pipe.query_layout()[name]
    return o, o + w


if __name__ == "__main__":
    main()
