"""The paper's own workload: the ApproxIoT analytics pipeline (no LM).

The port's own copy of ``repro.configs.approxiot_paper``: a 4-level tree
(8 sources -> 4 -> 2 -> 1 root), 4 sub-streams, 1-second (1-tick)
windows.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    name: str = "approxiot-paper"
    fanin: tuple = (4, 2, 1)      # sampling levels after the 8 sources
    num_sources: int = 8
    num_strata: int = 4
    capacity: int = 8192          # per-node interval buffer
    sampling_fraction: float = 0.1
    window_ticks: int = 1

    def sample_sizes(self) -> list:
        base = int(self.capacity * self.sampling_fraction)
        return [base for _ in self.fanin]


CONFIG = PipelineConfig()
