"""Hand-written Hopper kernels of the port, one package per kernel.

Each package keeps the reference's layout: ``ref.py`` is the plain
PyTorch version (what the CPU path and the tests run), ``ops.py`` the
wrapper that launches the CUDA kernel from ``repro_torch/csrc`` on a
CUDA tensor and calls ``ref.py`` on a CPU tensor. ``LAUNCHES`` counts
kernel launches per wrapper, so a run can show which kernels it used.
"""
from __future__ import annotations

LAUNCHES: dict[str, int] = {
    "fused_level_tick": 0,
    "fused_select": 0,
    "stratified_stats": 0,
    "cms_update": 0,
    "quantile_compact": 0,
    "sample_mask": 0,
    "segment_sum": 0,
    "flash_attention": 0,
}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
