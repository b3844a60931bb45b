"""The declarative pipeline API of the port.

    spec  = PipelineSpec(topology=..., sampler=..., budget=...)
    pipe  = compile(spec, device="cuda")
    state = pipe.init()
    state, answers = pipe.run_epoch(state, pipe.default_key, values,
                                    strata, counts)
"""
from repro_torch.api.pipeline import (CompiledPipeline, PipelineState,
                                      WindowAnswers, compile,
                                      program_cache_stats)
from repro_torch.api.spec import (BudgetSpec, PipelineSpec, SamplerSpec,
                                  SpecError, StrataSpec, TelemetrySpec,
                                  TenantSpec, TopologySpec, resolve)

__all__ = [
    "PipelineSpec", "TopologySpec", "SamplerSpec", "BudgetSpec",
    "TelemetrySpec", "StrataSpec", "TenantSpec", "SpecError", "resolve",
    "compile", "CompiledPipeline", "PipelineState", "WindowAnswers",
    "program_cache_stats",
]
