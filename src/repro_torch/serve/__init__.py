"""The always-on streaming serve plane (the port of ``repro.serve``).

``StreamingExecutor`` fronts a compiled pipeline with the subscribe →
pump → stop lifecycle: per-shard bounded queues with explicit
backpressure (``queues``), double-buffered host staging (``staging``),
and straggler-tolerant window publication with Eq. 9-widened partial
answers (``windows``). ``sources`` provides subscribable synthetic and
deterministic sources plus ``LateShardSource`` straggler injection.
"""
from repro_torch.serve.executor import StreamingExecutor
from repro_torch.serve.queues import POLICIES, BoundedShardQueue
from repro_torch.serve.sources import (ConstantSource, LateShardSource,
                                       SyntheticSource)
from repro_torch.serve.staging import DoubleBuffer, StagedEpoch
from repro_torch.serve.windows import PublishedWindow, WindowPublisher

__all__ = [
    "StreamingExecutor", "BoundedShardQueue", "POLICIES", "DoubleBuffer",
    "StagedEpoch", "WindowPublisher", "PublishedWindow", "ConstantSource",
    "SyntheticSource", "LateShardSource",
]
