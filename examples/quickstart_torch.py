"""Quickstart on the PyTorch/CUDA port: the declarative pipeline API.

The same job as ``examples/quickstart.py``, run by ``repro_torch``: the
8-sources → 4 → 2 → 1 edge topology, the weighted hierarchical sampler
at a 10% budget, and a tenant of standing queries answered at the root
every window. It runs on a CUDA card by default; pass ``cpu`` to run the
plain PyTorch path on the CPU:

    PYTHONPATH=src python examples/quickstart_torch.py [cuda|cpu]
"""
import sys

from repro_torch import (PipelineSpec, SamplerSpec, TelemetrySpec,
                         TopologySpec, compile)
from repro_torch.data import stream as S
from repro_torch.obs import snapshot
from repro_torch.query import QueryRegistry


def main(device: str = "cuda"):
    """Run one epoch on ``device``; returns ``(pipe, state, rows)``."""
    # -- the whole system, declaratively ----------------------------------
    spec = PipelineSpec(
        topology=TopologySpec(fanin=(4, 2, 1), capacity=2048, num_strata=4),
        sampler=SamplerSpec(mode="whs", backend="topk", fraction=0.1),
        tenants=(QueryRegistry().register_sum().register_mean()
                 .register_quantile("quantiles", (0.5, 0.99))
                 .as_tenant("demo"),),
        telemetry=TelemetrySpec(enabled=True),
    )
    pipe = compile(spec, device=device)
    state = pipe.init()

    # -- one epoch of the paper's Gaussian sub-streams ---------------------
    sources = [S.StreamSource(S.paper_gaussian(rates=(200,) * 4), seed=i)
               for i in range(8)]
    batch = S.batch_ingest(sources, ticks=8, n_nodes=4, width=2048)
    state, wa = pipe.run_epoch(state, pipe.default_key, batch.values,
                               batch.strata, batch.counts)

    # -- windowed answers ± bounds -----------------------------------------
    rows = pipe.rows(wa)
    approx = sum(r["sum"] for r in rows)
    kept = sum(r["n_sampled"] for r in rows)
    tel = snapshot(state)
    bound = tel["bound_2sigma"]
    print(f"{len(rows)} windows on {pipe.device}, {kept}/"
          f"{batch.exact_count} items at the root (10% budget, realized "
          f"hop-0 fraction {tel['levels'][0]['effective_fraction']:.1%})")
    print(f"SUM  ≈ {approx:.4e} ± {bound:.2e} (2σ)   exact "
          f"{batch.exact_sum:.4e}  (|err| "
          f"{abs(approx - batch.exact_sum) / batch.exact_sum:.4%})")
    last = rows[-1]
    p50, p99 = pipe.answer(last["answers"], "quantiles", tenant="demo")
    print(f"standing queries (tenant 'demo', last window): "
          f"sum ≈ {pipe.answer(last['answers'], 'sum', tenant='demo')[0]:.4e}"
          f", p50 ≈ {p50:.1f}, p99 ≈ {p99:.1f}")
    if abs(approx - batch.exact_sum) > 1.5 * bound:
        raise SystemExit("SUM outside 3σ of the exact sum")
    print("estimates within bounds — done.")
    return pipe, state, rows


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
