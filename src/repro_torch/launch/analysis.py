"""Step cost → roofline terms.

The port of ``repro/launch/analysis.py``. The cost source is
``launch.hlocost.OpCost``: the operations one step dispatches on a rank,
counted with their trip counts as they run (a layer loop runs each body
once per layer), per chip. There is no compiled artifact, so the
reference's XLA fields (``xla_cost_flops``, ``xla_bytes_accessed``,
``hlo_size``) have no counterpart; ``memory`` holds this rank's argument
bytes, the sum of its local shards.

Terms (per chip):
    compute_s    = flops / PEAK_FLOPS
    memory_s     = bytes / HBM_BW
    collective_s = collective_operand_bytes / LINK_BW

The constants are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense, at
the full 700 W limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s
of HBM3, and NVLink 4 at 900 GB/s to the other cards of a host, 450 GB/s
each way.
"""
from __future__ import annotations

from typing import Any

PEAK_FLOPS = 989e12          # bf16 FLOP/s, dense (H100 SXM data sheet)
HBM_BW = 3.35e12             # B/s, HBM3 (H100 SXM data sheet)
LINK_BW = 450e9              # B/s each way, NVLink 4 (H100 SXM data sheet)


def roofline_terms(flops: float, bytes_: float, coll_bytes: float) -> dict:
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_ / HBM_BW,
        "collective_s": coll_bytes / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = terms["compute_s"] / bound if bound > 0 else 0.0
    return dict(terms, dominant=dominant, step_s=bound, compute_fraction=frac)


def summarize(cost: dict, *, chips: int,
              argument_bytes: float | None = None) -> dict[str, Any]:
    """A record from ``hlocost`` totals (``OpCost.totals()``) of one
    rank of ``chips``: the reference's keys for what the port counts."""
    flops = cost["flops"]
    return {
        "flops_per_chip": flops,
        "dot_flops_per_chip": cost["dot_flops"],
        "bytes_per_chip": cost["bytes"],
        "collective_bytes_per_chip": cost["collective_bytes"],
        "collectives": cost["collectives"],
        "memory": {"argument_bytes": argument_bytes},
        "terms": roofline_terms(flops, cost["bytes"],
                                cost["collective_bytes"]),
        "chips": chips,
    }
