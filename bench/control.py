"""The output check's control: the plain reference in bfloat16, put in
the program's place, must come out as not correct.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 [--epochs 12]

For each seed it builds the cell's pool at the cell's own size, plays a
run's schedule (two warm-up epochs, then ``--epochs`` window epochs
cycling through the pool), and compares, on the windows a run would
draw for the full reference, the reference with the stream's values and
the priorities held in bfloat16 (the step that would tempt a later
change: half the bytes of every buffer) against the float32 reference,
with the numbers and limits of ``compare``. A cell with tenants also
plays the standing queries: the reference in bfloat16 (the tree's and
the sketches' inputs) is the program through every epoch of the
schedule, and its answers, bounds and sketch states are checked as a
run's are (``compare.check_queries``). It prints one JSON line a seed.
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import cell, compare, registry, traffic  # noqa: E402


def control_numbers(workload: str, seed: int, epochs: int, device,
                    precision: str = "bfloat16") -> dict:
    bm = registry.benchmark()
    wl = registry.workload(bm, workload)
    cfg = registry.config(bm, wl["config"])
    mix = registry.traffic(wl["traffic"])
    ref = registry.reference(cfg["reference"])
    tree = cell.reference_tree(ref, cfg, mix)
    key = ref.root_key(int(seed) % (1 << 31))
    pool = traffic.make_pool(cfg, mix, seed, device)
    ticks = int(mix["ticks_per_epoch"])
    n_epochs = cell.WARM_EPOCHS + epochs
    window = list(range(cell.WARM_EPOCHS * ticks, n_epochs * ticks))
    last = n_epochs * ticks - 1
    mism, gap, hgap = 0, 0.0, 0.0
    for k in compare.draw_ticks(window, last, seed, cell.CHECKED_WINDOWS):
        v, s, c = pool.epoch_host((k // ticks) % len(pool))
        i = k % ticks
        want = ref.tick(tree, key, k + 1, v[i], s[i], c[i], device=device)
        got = ref.tick(tree, key, k + 1, v[i], s[i], c[i], device=device,
                       precision=precision)
        m, g, h = compare.compare_tick(got, want)
        mism, gap, hgap = mism + m, max(gap, g), max(hgap, h)
        if k == last:
            m, w = compare.compare_levels(got["levels"], want["levels"])
            mism, gap = mism + m, max(gap, w)
    numbers = {"mismatches": mism, "answer_gap": gap, "histogram_gap": hgap}
    if cfg.get("tenants"):
        numbers.update(query_control(ref, tree, key, pool, cfg, ticks,
                                     n_epochs, seed, device, precision))
    return numbers


def query_control(ref, tree, key, pool, cfg: dict, ticks: int,
                  n_epochs: int, seed: int, device, precision: str) -> dict:
    """The standing queries' numbers with the reference in ``precision``
    in the program's place over the whole schedule."""
    qref = registry.reference(cfg["query_reference"])
    plan = qref.Plan(cfg["tenants"], tree.num_strata)
    root_level = len(tree.fanin) - 1
    state = plan.init()
    runs, states = [], {}
    for e in range(n_epochs):
        v, s, c = pool.epoch_host(e % len(pool))
        ans, bnd = [], []
        for i in range(ticks):
            t = e * ticks + i + 1
            r = ref.tick(tree, key, t, v[i], s[i], c[i], device=device,
                         precision=precision)
            state, a, b = plan.window(state, r["root"],
                                      ref.node_key(key, t, root_level, 0),
                                      precision=precision, device=device)
            ans.append(a)
            bnd.append(b)
        runs.append({"pool": e % len(pool), "window": e >= cell.WARM_EPOCHS,
                     "answers": {"tick": np.arange(ticks) + e * ticks + 1,
                                 "answers": np.stack(ans),
                                 "bounds": np.stack(bnd)}})
        states[e] = [{"active": True, "queries": st} for st in state]
    checked = compare.draw_epochs(
        [e for e, run in enumerate(runs) if run["window"]], n_epochs - 1,
        seed, cell.CHECKED_EPOCHS)
    return compare.check_queries(ref, tree, key, pool, runs, qref, plan,
                                 states, checked, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    limits = registry.limits(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control_numbers(args.workload, seed, args.epochs,
                                  torch.device(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers,
                          "correct": compare.verdict(numbers, limits),
                          "seconds": time.perf_counter() - t0}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
