"""The output check's control: the plain reference in bfloat16, put in
the program's place, must come out as not correct.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 [--epochs 12]

For each seed it builds the cell's pool at the cell's own size, plays a
run's schedule (two warm-up epochs, then ``--epochs`` window epochs
cycling through the pool), and compares, on the windows a run would
draw for the full reference, the reference with the stream's values and
the priorities held in bfloat16 (the step that would tempt a later
change: half the bytes of every buffer) against the float32 reference,
with the numbers and limits of ``compare``. It prints one JSON line a
seed. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench")]

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
    return {"mismatches": mism, "answer_gap": gap, "histogram_gap": hgap}


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
