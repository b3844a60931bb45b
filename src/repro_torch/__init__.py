"""ApproxIoT's edge-analytics pipeline in PyTorch, with CUDA kernels.

A port of the JAX package ``repro``: the weighted hierarchical sampler
(WHS) and its SRS baseline over the paper's edge tree, run as epochs of
ticks (``repro_torch.api``) or tick by tick (``core.tree.HostTree``, the
analytics driver ``launch.analytics``) on a CUDA device (or, on request,
the CPU), with tenants of standing queries answered at the root every
window. The kernels on those paths — ``fused_level_tick``,
``fused_select``, ``stratified_stats`` and ``sample_mask`` for the
sampler, ``cms_update`` and ``quantile_compact`` for the sketches, and
``segment_sum`` for the float sums in item order — are written in CUDA
C++ for Hopper (``repro_torch/csrc``).
"""
from repro_torch.api import (BudgetSpec, CompiledPipeline, PipelineSpec,
                             PipelineState, SamplerSpec, SpecError,
                             StrataSpec, TelemetrySpec, TenantSpec,
                             TopologySpec, WindowAnswers, compile, resolve)

__all__ = [
    "PipelineSpec", "TopologySpec", "SamplerSpec", "BudgetSpec",
    "TelemetrySpec", "StrataSpec", "TenantSpec", "SpecError", "resolve",
    "compile", "CompiledPipeline", "PipelineState", "WindowAnswers",
]
