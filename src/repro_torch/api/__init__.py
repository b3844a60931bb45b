"""The declarative pipeline API of the port.

    spec  = PipelineSpec(topology=..., sampler=..., budget=...)
    pipe  = compile(spec, device="cuda")
    state = pipe.init()
    state, answers = pipe.run_epoch(state, pipe.default_key, values,
                                    strata, counts)
    pipe, state = pipe.admit(state, tenant)       # tenant churn
    save_state(root, step, state, pipeline=pipe)  # checkpoints
"""
from repro_torch.api.pipeline import (CompiledPipeline, PipelineState,
                                      WindowAnswers, compile,
                                      program_cache_stats, restore_state,
                                      save_state)
from repro_torch.api.spec import (BudgetSpec, PipelineSpec, SamplerSpec,
                                  SpecError, StrataSpec, TelemetrySpec,
                                  TenantSpec, TopologySpec, resolve)

compile_pipeline = compile   # for call sites that shadow the builtin

__all__ = [
    "PipelineSpec", "TopologySpec", "SamplerSpec", "BudgetSpec",
    "TelemetrySpec", "StrataSpec", "TenantSpec", "SpecError", "resolve",
    "compile", "compile_pipeline", "CompiledPipeline", "PipelineState",
    "WindowAnswers", "program_cache_stats", "save_state", "restore_state",
]
