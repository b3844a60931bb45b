"""ApproxIoT's edge-analytics pipeline in PyTorch, with CUDA kernels.

A port of the JAX package ``repro``: the weighted hierarchical sampler
(WHS) and its SRS baseline over the paper's edge tree, run as an epoch
of ticks on a CUDA device (or, on request, the CPU), with tenants of
standing queries answered at the root every window. The five kernels on
that path — ``fused_level_tick``, ``fused_select`` and
``stratified_stats`` for the sampler, ``cms_update`` and
``quantile_compact`` for the sketches — are written in CUDA C++ for
Hopper (``repro_torch/csrc``). See ``repro_torch.api``.
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
