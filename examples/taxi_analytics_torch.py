"""Paper case study (§VI-A) on the PyTorch/CUDA port: "what is the total
taxi payment per window?"

The same three runs as ``examples/taxi_analytics.py``, driven by
``repro_torch.launch.analytics``: NYC-taxi-like fares (lognormal, rates
per zone) through the paper's edge topology — 8 sources → 4 edge → 2
edge → 1 datacenter — at a 10% sampling fraction with the weighted
hierarchical sampler, against the SRS baseline and against keeping
everything. It runs on a CUDA card by default; pass ``cpu`` to run the
plain PyTorch path on the CPU:

    PYTHONPATH=src python examples/taxi_analytics_torch.py [cuda|cpu] \\
        [--fraction 0.1] [--ticks 10]
"""
import argparse

from repro_torch.data import stream as S
from repro_torch.launch.analytics import run_pipeline


def main(device: str = "cuda", fraction: float = 0.1, ticks: int = 10):
    """Run the three pipelines on ``device`` and print the comparison;
    returns ``(whs, srs, native)`` reports."""
    specs = S.taxi_like()
    print(f"taxi-like stream: {len(specs)} zones, "
          f"{sum(s.rate for s in specs):.0f} rides/s offered, "
          f"fraction {fraction:.0%}\n")

    # All three on the scan engine; telemetry on for the headline run, so
    # the printed bound is the realized counters' (answers are bitwise
    # the same either way).
    whs = run_pipeline(specs, fraction=fraction, ticks=ticks, mode="whs",
                       warmup_ticks=2, seed=42, engine="scan",
                       telemetry=True, device=device)
    srs = run_pipeline(specs, fraction=fraction, ticks=ticks, mode="srs",
                       warmup_ticks=2, seed=42, engine="scan",
                       device=device)
    native = run_pipeline(specs, fraction=1.0, ticks=ticks, mode="whs",
                          warmup_ticks=2, seed=42, engine="scan",
                          device=device)

    print(f"{'':14}{'ApproxIoT':>12}{'SRS':>12}{'native':>12}")
    print(f"{'accuracy loss':14}{whs['accuracy_loss']:>12.4%}"
          f"{srs['accuracy_loss']:>12.4%}{0.0:>12.4%}")
    print(f"{'items kept':14}{whs['bandwidth_fraction']:>12.1%}"
          f"{srs['bandwidth_fraction']:>12.1%}{1.0:>12.1%}")
    print(f"{'items/s':14}{whs['throughput_items_s']:>12.0f}"
          f"{srs['throughput_items_s']:>12.0f}"
          f"{native['throughput_items_s']:>12.0f}")
    tel = whs["telemetry"]
    print(f"\nSUM ≈ {whs['approx_sum']:.4e} ± {tel['bound_2sigma']:.2e} "
          f"(exact {whs['exact_sum']:.4e}, within 2σ: "
          f"{whs['within_2sigma']}, realized rel bound "
          f"{tel['rel_bound_2sigma']:.4%})")
    print(f"speedup vs native: "
          f"{whs['throughput_items_s'] / native['throughput_items_s']:.2f}×"
          f" on {device}")
    return whs, srs, native


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("device", nargs="?", default="cuda",
                    choices=["cuda", "cpu"])
    ap.add_argument("--fraction", type=float, default=0.1)
    ap.add_argument("--ticks", type=int, default=10)
    args = ap.parse_args()
    main(args.device, args.fraction, args.ticks)
