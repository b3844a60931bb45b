"""What the port's spans cost when they record, on the card.

Runs ``run_epoch`` at a benchmark cell's shapes (its configuration and
mix, the ingest from the harness's pool, as ``bench/run.py`` makes it)
with no profiler, epochs alternating between the default tracer enabled
and disabled, and prints each side's median and quartiles in ms an
epoch: the call (``run_epoch`` to its return) and the whole epoch (the
call and the answers read to the host). Then the host's cost of one
empty span, enabled and disabled, over 10,000 spans. One JSON line last.

    python3 tools/span_cost.py [--workload testbed.peak-f10] [--epochs 20]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="testbed.peak-f10")
    ap.add_argument("--epochs", type=int, default=20,
                    help="epochs timed on each side")
    ap.add_argument("--seed", type=int, default=2147483659)
    args = ap.parse_args(argv)
    import torch

    from harness import cell, registry, traffic
    from repro_torch.api import compile as compile_pipeline
    from repro_torch.obs.trace import get_tracer

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    bm = registry.benchmark()
    wl = registry.workload(bm, args.workload)
    cfg = registry.config(bm, wl["config"])
    mix = registry.traffic(wl["traffic"])
    pool = traffic.make_pool(cfg, mix, args.seed, dev)
    pipe = compile_pipeline(cell.build_spec(cfg, mix, args.seed), device=dev)
    state, key, tracer = pipe.init(), pipe.default_key, get_tracer()
    times = {True: [], False: []}

    def epoch(i: int, on: bool):
        nonlocal state
        e = i % len(pool)
        with tracer.on(on):
            t0 = time.perf_counter()
            state, wa = pipe.run_epoch(state, key, pool.values[e],
                                       pool.strata[e], pool.counts[e])
            t1 = time.perf_counter()
            for f in cell.FIELDS:
                getattr(wa, f).cpu()
            t2 = time.perf_counter()
        return t1 - t0, t2 - t0

    for i in range(cell.WARM_EPOCHS):
        epoch(i, False)
    for i in range(2 * args.epochs):
        on = i % 4 in (0, 3)          # on, off, off, on, ...
        times[on].append(epoch(i, on))
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"workload": args.workload, "epochs": args.epochs, "card": name,
           "spans_a_run": len(tracer.events)}
    for on, label in ((True, "on"), (False, "off")):
        for i, what in ((0, "call"), (1, "epoch")):
            q = statistics.quantiles([1e3 * t[i] for t in times[on]], n=4)
            out[f"{what}_ms_{label}"] = q
            print(f"tracer {label}: {what} ms quartiles "
                  f"{q[0]:.3f} / {q[1]:.3f} / {q[2]:.3f} "
                  f"({len(times[on])} epochs)", file=sys.stderr)
    for on, label in ((True, "on"), (False, "off")):
        with tracer.on(on):
            t0 = time.perf_counter()
            for _ in range(10_000):
                with tracer.span("cost"):
                    pass
            out[f"span_us_{label}"] = (time.perf_counter() - t0) * 1e2
        print(f"tracer {label}: {out[f'span_us_{label}']:.3f} us an empty "
              f"span", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
