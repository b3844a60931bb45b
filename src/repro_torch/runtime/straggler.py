"""Straggler mitigation by ApproxIoT's weight calibration (Eq. 9).

The port's own copy of ``repro.runtime.straggler`` (numpy only). A shard
(an edge node, or a data-parallel worker) that misses the interval
deadline has simply not arrived: its count ``c_i`` drops, and scaling
the weights of the shards that did arrive by ``1/α`` keeps a linear
query an unbiased estimate of the full stream. ``DeadlineTracker``
decides who arrived: the deadline is a multiple of the median shard
latency over a rolling window.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    deadline_factor: float = 2.0   # × median shard latency
    min_quorum: float = 0.5        # below this arrival rate, wait for all


def calibrate_weights(weight: np.ndarray, present: np.ndarray) -> np.ndarray:
    """Eq. 9 applied to shard dropout.

    ``weight`` f32[B] — per-item weights; ``present`` bool[B] — items whose
    shard met the deadline. The surviving weights are scaled by
    (Σ all w)/(Σ present w), absent ones get 0.
    """
    total = float(weight.sum())
    kept = float(weight[present].sum())
    if kept <= 0.0:
        return np.zeros_like(weight)
    alpha = kept / total                      # fraction that arrived
    out = np.where(present, weight / alpha, 0.0)
    return out.astype(weight.dtype)


class DeadlineTracker:
    """Rolling per-shard latency stats → who is a straggler this step."""

    def __init__(self, num_shards: int, cfg: StragglerConfig | None = None):
        self.cfg = cfg or StragglerConfig()
        self.lat = np.zeros((0, num_shards), np.float64)

    def observe(self, shard_latencies: np.ndarray) -> np.ndarray:
        """Record latencies; return bool[num_shards] present-mask."""
        self.lat = np.vstack([self.lat[-63:], shard_latencies[None]])
        med = float(np.median(self.lat))
        deadline = self.cfg.deadline_factor * med
        present = shard_latencies <= deadline
        if present.mean() < self.cfg.min_quorum:
            # a degenerate interval: wait for everyone rather than bias hard
            present = np.ones_like(present)
        return present
