"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells). The
last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers the output check compared, each
beside its limit. The run needs as many CUDA devices as the cell asks
for and exits with code 2, printing no result, without them.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

from harness import guard, registry  # noqa: E402


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"not read (exit {out.returncode})")


def report(result: dict) -> None:
    """The compared numbers on standard error, then the result line."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bad = guard.loaded_forbidden()
    if bad:
        print(f"JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 1
    chips = int(registry.workload(registry.benchmark(),
                                  args.workload)["chips"])
    t_import = time.perf_counter()
    import torch

    print(f"import torch {time.perf_counter() - t_import:.3f} s",
          file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from harness import cell

    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_PROCESS)
    result["device"]["power_limit"] = power_limit()
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
