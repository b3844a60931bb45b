"""One run of one cell: set-up, the measured window, the output check.

The entry the window drives is the port's front door:
``repro_torch.api.compile(spec, device)``, ``init()``, then
``run_epoch(state, default_key, values, strata, counts)`` in a closed
loop with one epoch in flight. Each epoch's ingest is a host (pageable)
numpy array ``[T, fanin[0], width]`` from the pool, as a stream
consumer would hand it over; the epoch's ``WindowAnswers`` are read to
the host, which publishes its windows, before the next call.

Set-up (``setup_s``, from process start to the first timed call):
importing the program, the pool, compiling the spec, and ``WARM_EPOCHS``
epochs on the cell's own shapes (the first run in a checkout builds the
CUDA kernels there, under ``build/``). After the window, the device's
memory peak is read, the state is copied to the host and the program's
tensors are freed; then the plain reference checks the run.

A configuration with ``tenants`` (``harness/tenants.py``) runs their
standing queries at the root: the readback also moves each window's
``answers`` and ``bounds`` to the host, as a dashboard publishes them,
and after it each epoch's sketch state is cloned on the device (the
span ``bench.snapshot``), so that the check can start a drawn epoch
from the program's own state (``compare.check_queries``; the first two
epochs chain from ``init`` in the reference's own state).
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from harness import compare, guard, peaks, registry, tenants, trace, traffic

WARM_EPOCHS = 2
# A traced run traces this many seconds of its window (at least one
# epoch), which keeps the profiler's trace to tens of MB.
TRACE_SECONDS = 2.0
# Windows, beside the run's last, that the full reference recomputes.
CHECKED_WINDOWS = 16
# Window epochs, beside the first two epochs and the last, whose
# standing queries the reference recomputes (a cell with tenants).
CHECKED_EPOCHS = 4
FIELDS = ("tick", "ok", "sum", "sum_var", "mean", "mean_var", "n_sampled",
          "histogram", "n_forwarded")
TENANT_FIELDS = FIELDS + ("answers", "bounds")


class Context:
    """What a per-layer reader reads: the trace, the harness's own host
    clock per epoch and over the traced window, the tree's flows over the
    traced ticks, peaks, and the cell's configuration."""

    def __init__(self, tr, host, flows, windows, peaks_, config=None):
        self.trace, self.host, self.flows = tr, host, flows
        self.windows, self.peaks, self.config = windows, peaks_, config


def build_spec(cfg: dict, mix: dict, seed: int):
    from repro_torch.api import (PipelineSpec, SamplerSpec, TelemetrySpec,
                                 TopologySpec)

    topo, samp = cfg["topology"], cfg["sampler"]
    return PipelineSpec(
        topology=TopologySpec(fanin=tuple(topo["fanin"]),
                              capacity=int(topo["capacity"]),
                              interval_ticks=tuple(topo["interval_ticks"]),
                              num_strata=len(cfg["stream"]["substreams"])),
        sampler=SamplerSpec(mode=samp["mode"], backend=samp["backend"],
                            allocation=samp["allocation"],
                            fraction=float(mix["fraction"])),
        seed=int(seed) % (1 << 31),
        telemetry=TelemetrySpec(enabled=bool(cfg["telemetry"])),
        **({"tenants": tenants.specs(cfg)} if cfg.get("tenants") else {}))


def readback_fields(spec) -> tuple:
    """What the timed readback moves to the host."""
    return TENANT_FIELDS if spec.tenants else FIELDS


def reference_tree(ref, cfg: dict, mix: dict):
    topo = cfg["topology"]
    if any(int(i) != 1 for i in topo["interval_ticks"]):
        raise ValueError("the reference flushes every level every tick")
    return ref.Tree(fanin=tuple(topo["fanin"]),
                    capacity=int(topo["capacity"]),
                    num_strata=len(cfg["stream"]["substreams"]),
                    fraction=float(mix["fraction"]),
                    allocation=cfg["sampler"]["allocation"])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_state(state) -> dict:
    tr = state.tree
    levels = [{"values": tr.values[l].cpu().numpy(),
               "strata": tr.strata[l].cpu().numpy(),
               "fill": tr.fill[l].cpu().numpy(),
               "dropped": tr.dropped[l].cpu().numpy(),
               "w": tr.w_in[l].cpu().numpy(), "c": tr.c_in[l].cpu().numpy()}
              for l in range(len(tr.values))]
    tel = {f: getattr(tr.telemetry, f).cpu().numpy()
           for f in ("items_in", "items_kept", "flushes", "saturation_hits",
                     "windows")}
    return {"levels": levels, "telemetry": tel, "tick": int(state.tick)}


def _flows(epochs, pool, n_levels: int) -> dict:
    """Items in and rows out at each level over ``epochs``, from the
    ingest counts and the published answers; the ticks, and those in
    which the root sampled anything."""
    lin = np.zeros(n_levels)
    lout = np.zeros(n_levels)
    ticks = sampled_ticks = 0
    for ep in epochs:
        a = ep["answers"]
        fwd = a["n_forwarded"].astype(np.float64).sum(0)
        lin[0] += float(pool.counts_host(ep["pool"]).sum())
        lin[1:] += fwd
        lout[:-1] += fwd
        lout[-1] += float(a["n_sampled"].sum())
        ticks += len(a["tick"])
        sampled_ticks += int(np.count_nonzero(a["n_sampled"]))
    return {"level_in": list(lin), "level_out": list(lout), "ticks": ticks,
            "sampled_ticks": sampled_ticks}


def run(workload: str, seed: int, seconds: float, traced: bool, device,
        t_process: float) -> dict:
    """The result of one run (the last line's object, with ``checks``)."""
    device = torch.device(device)
    bm = registry.benchmark()
    wl = registry.workload(bm, workload)
    cfg = registry.config(bm, wl["config"])
    mix = registry.traffic(wl["traffic"])
    limits = registry.limits(workload)
    if mix.get("loop", "closed") != "closed" or int(mix.get("in_flight",
                                                            1)) != 1:
        raise ValueError("the harness drives a closed loop with one epoch "
                         "in flight")
    ref = registry.reference(cfg["reference"])
    tree = reference_tree(ref, cfg, mix)
    t_phase = [time.perf_counter()]
    from repro_torch.api import compile as compile_pipeline

    t_phase.append(time.perf_counter())
    spec = build_spec(cfg, mix, seed)
    pool = traffic.make_pool(cfg, mix, seed, device)
    _sync(device)
    t_phase.append(time.perf_counter())
    pipe = compile_pipeline(spec, device=device)
    state = pipe.init()
    key = pipe.default_key
    fields = readback_fields(spec)
    epochs: list[dict] = []
    snapshots: list = []

    def epoch(in_window: bool):
        nonlocal state
        e = len(epochs) % len(pool)
        t_call = time.perf_counter()
        with torch.profiler.record_function("bench.run_epoch"):
            state, wa = pipe.run_epoch(state, key, pool.values[e],
                                       pool.strata[e], pool.counts[e])
        t_disp = time.perf_counter()
        with torch.profiler.record_function("bench.readback"):
            ans = {f: getattr(wa, f).cpu().numpy() for f in fields}
        t_read = time.perf_counter()
        if spec.tenants:
            with torch.profiler.record_function("bench.snapshot"):
                snapshots.append(tenants.clone(state.tree.qstate))
        epochs.append({"pool": e, "window": in_window, "answers": ans,
                       "t_call": t_call, "t_disp": t_disp,
                       "t_read": t_read})

    _sync(device)
    t_phase.append(time.perf_counter())
    for _ in range(WARM_EPOCHS):
        epoch(False)
    _sync(device)
    t_phase.append(time.perf_counter())
    setup_s = t_phase[-1] - t_process
    print("setup_s {:.3f}: start {:.3f}, import {:.3f}, pool {:.3f}, "
          "compile {:.3f}, warm-up {:.3f}".format(setup_s, t_phase[0] - t_process,
                                  *np.diff(t_phase)), file=sys.stderr)

    prof = None
    if traced:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    span = min(seconds, TRACE_SECONDS) if traced else seconds
    t_start = time.perf_counter()
    while True:
        epoch(True)
        if epochs[-1]["t_read"] - t_start >= span:
            break
    t_end = epochs[-1]["t_read"]
    if prof is not None:
        prof.stop()
    _sync(device)
    win = [ep for ep in epochs if ep["window"]]
    lat = np.array([ep["t_read"] - ep["t_call"] for ep in win]) * 1e3
    disp = np.array([ep["t_disp"] - ep["t_call"] for ep in win]) * 1e3
    print("window: {} epochs; epoch ms min {:.2f} p50 {:.2f} p95 {:.2f} "
          "max {:.2f}; run_epoch ms p50 {:.2f}".format(
              len(win), lat.min(), *np.percentile(lat, [50, 95]), lat.max(),
              np.median(disp)), file=sys.stderr)
    ticks = win[0]["answers"]["tick"].shape[0]
    windows = ticks * len(win)
    published = sum(int(np.count_nonzero(ep["answers"]["ok"])) for ep in win)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}

    metrics = {}
    breakdown = None
    if traced:
        host = {"dispatch_s": [ep["t_disp"] - ep["t_call"] for ep in win],
                "readback_s": [ep["t_read"] - ep["t_disp"] for ep in win],
                "window_s": t_end - t_start}
        tr = trace.read(prof)
        del prof
        ctx = Context(tr, host, _flows(win, pool, len(tree.fanin)), windows,
                      peaks.for_device(kind), cfg)
        for m in registry.cell_metrics(bm, workload, traced=True):
            v = registry.metric_reader(m["name"]).read(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr.ops:
            dev["busy_s"] = trace.busy(tr)
            dev["window_s"] = tr.window_s
            breakdown = trace.breakdown(tr)
    else:
        items = sum(float(pool.counts_host(ep["pool"]).sum()) for ep in win)
        # Every window of an epoch waits from the call to the readback.
        values = {"items_per_s": items / (t_end - t_start),
                  "window_p95_ms": float(np.percentile(np.repeat(lat, ticks),
                                                       95)),
                  "setup_s": setup_s}
        for m in registry.cell_metrics(bm, workload, traced=False):
            metrics[m["name"]] = {"value": values[registry.quantity(m)],
                                  "unit": m["unit"]}

    final = _host_state(state)
    if spec.tenants:
        checked = compare.draw_epochs(
            [i for i, ep in enumerate(epochs) if ep["window"]],
            len(epochs) - 1, seed, CHECKED_EPOCHS)
        q_states = {e: tenants.host_state(snapshots[e], pipe.plan)
                    for e in {e - 1 for e in checked if e} | set(checked)}
        del snapshots
    del state, pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = compare.check_run(ref, tree, ref.root_key(spec.seed), pool,
                                epochs, final, seed, device,
                                CHECKED_WINDOWS)
    print(f"output check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    if spec.tenants:
        t_check = time.perf_counter()
        qref = registry.reference(cfg["query_reference"])
        numbers.update(compare.check_queries(
            ref, tree, ref.root_key(spec.seed), pool, epochs, qref,
            qref.Plan(cfg["tenants"], tree.num_strata), q_states, checked,
            device))
        print(f"query check {time.perf_counter() - t_check:.3f} s "
              f"(epochs {checked})", file=sys.stderr)
    result = {"correct": compare.verdict(numbers, limits),
              "attempted": windows, "failed": windows - published,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": numbers[name], "limit": limits[name]}
                        for name in limits}
    bad = guard.loaded_forbidden()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: "
                           f"{bad}")
    return result
