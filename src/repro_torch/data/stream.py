"""Synthetic sub-streams and epoch ingest — the paper's §V workloads.

The port's own copy of the parts of ``repro.data.stream`` the main path
uses: the sub-stream description, the paper's Gaussian mix
A(μ=10, σ=5), B(1e3, 50), C(1e4, 500), D(1e5, 5e3), one source node
drawing from a numpy generator, and the tick-major epoch ingest layout.
Draws are numpy's, so one seed gives the same items to both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

GAUSSIAN = [(10.0, 5.0), (1_000.0, 50.0), (10_000.0, 500.0),
            (100_000.0, 5_000.0)]


@dataclasses.dataclass
class SubstreamSpec:
    dist: str           # "gaussian" (the only kind this copy draws)
    params: tuple
    rate: float         # items per tick


def paper_gaussian(rates=(1000, 1000, 1000, 1000)) -> list[SubstreamSpec]:
    return [SubstreamSpec("gaussian", g, r) for g, r in zip(GAUSSIAN, rates)]


class StreamSource:
    """One source node emitting a mix of sub-streams each tick."""

    def __init__(self, specs: list[SubstreamSpec], seed: int = 0):
        self.specs = specs
        self.rng = np.random.default_rng(seed)

    def tick(self) -> tuple[np.ndarray, np.ndarray]:
        """→ (values f32[n], strata i32[n]) for one tick."""
        vals, strs = [], []
        for i, sp in enumerate(self.specs):
            n = self.rng.poisson(sp.rate)
            if n == 0:
                continue
            if sp.dist != "gaussian":
                raise ValueError(f"sub-stream kind {sp.dist!r} is not "
                                 f"ported; this copy draws 'gaussian'")
            v = self.rng.normal(sp.params[0], sp.params[1], n)
            vals.append(v)
            strs.append(np.full(n, i, np.int32))
        if not vals:
            return np.zeros(0, np.float32), np.zeros(0, np.int32)
        return (np.concatenate(vals).astype(np.float32),
                np.concatenate(strs))


def _pack_prefix(dst_v, dst_s, v, s, fill: int, width: int) -> int:
    """Write the prefix of ``v``/``s`` that fits at ``fill`` in a
    ``width``-slot row and drop the rest; returns the new fill."""
    take = min(len(v), width - fill)
    dst_v[fill:fill + take] = v[:take]
    dst_s[fill:fill + take] = s[:take]
    return fill + take


@dataclasses.dataclass
class IngestBatch:
    """One epoch of source→level-0 ingest, tick-major: ``values``/
    ``strata`` ``[T, n_nodes, width]``, ``counts`` ``[T, n_nodes]`` after
    truncation, ``offered`` before it, and the exact SUM and COUNT of
    everything offered (the ground truth)."""

    values: np.ndarray
    strata: np.ndarray
    counts: np.ndarray
    offered: np.ndarray
    exact_sum: float
    exact_count: int


def batch_ingest(sources: list[StreamSource], ticks: int, n_nodes: int,
                 width: int) -> IngestBatch:
    """An epoch's ingest for ``n_nodes`` level-0 nodes: source ``i``
    feeds node ``i % n_nodes``; per (tick, node) the sources' items are
    concatenated in source order and prefix-truncated at ``width``."""
    values = np.zeros((ticks, n_nodes, width), np.float32)
    strata = np.zeros((ticks, n_nodes, width), np.int32)
    counts = np.zeros((ticks, n_nodes), np.int32)
    offered = np.zeros((ticks, n_nodes), np.int32)
    exact_sum = 0.0
    exact_count = 0
    for t in range(ticks):
        fill = [0] * n_nodes
        for i, src in enumerate(sources):
            v, s = src.tick()
            exact_sum += float(v.sum())
            exact_count += len(v)
            node = i % n_nodes
            offered[t, node] += len(v)
            fill[node] = _pack_prefix(values[t, node], strata[t, node],
                                      v, s, fill[node], width)
        counts[t] = fill
    return IngestBatch(values, strata, counts, offered, exact_sum,
                       exact_count)
