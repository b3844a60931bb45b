"""Synthetic sub-streams and epoch ingest — the paper's §V workloads.

The port's own copy of ``repro.data.stream``'s streams:

* Gaussian sub-streams A(μ=10, σ=5), B(1e3, 50), C(1e4, 500),
  D(1e5, 5e3);
* Poisson sub-streams A(λ=10), B(100), C(1000), D(10000), and the skewed
  mix with λ_D = 1e7 (``SKEW_SHARES`` gives its arrival shares);
* ``taxi_like``: lognormal fares per zone (a stand-in for DEBS'15 NYC);
* ``pollution_like``: slow-moving AR(1) sensor values (a stand-in for
  the Brasov / CityBench sensors).

One source node draws from a numpy generator, in the reference's order,
so one seed gives the same items to both packages; then the tick-major
epoch ingest layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np

GAUSSIAN = [(10.0, 5.0), (1_000.0, 50.0), (10_000.0, 500.0),
            (100_000.0, 5_000.0)]
POISSON = [10.0, 100.0, 1_000.0, 10_000.0]
POISSON_SKEWED = [10.0, 100.0, 1_000.0, 10_000_000.0]

# §V-D arrival-rate settings (items/sec for sub-streams A:B:C:D)
RATE_SETTINGS = {
    "setting1": (50_000, 25_000, 12_500, 625),
    "setting2": (25_000, 25_000, 25_000, 25_000),
    "setting3": (625, 12_500, 25_000, 50_000),
}
# §V-E skew: share of items per sub-stream
SKEW_SHARES = (0.80, 0.1989, 0.001, 0.0001)


@dataclasses.dataclass
class SubstreamSpec:
    dist: str           # gaussian | poisson | taxi | pollution
    params: tuple
    rate: float         # items per tick


def paper_gaussian(rates=(1000, 1000, 1000, 1000)) -> list[SubstreamSpec]:
    return [SubstreamSpec("gaussian", g, r) for g, r in zip(GAUSSIAN, rates)]


def paper_poisson(rates=(1000, 1000, 1000, 1000),
                  skewed=False) -> list[SubstreamSpec]:
    lam = POISSON_SKEWED if skewed else POISSON
    return [SubstreamSpec("poisson", (l,), r) for l, r in zip(lam, rates)]


def taxi_like(num_zones: int = 4, rate: float = 1000) -> list[SubstreamSpec]:
    return [SubstreamSpec("taxi", (2.3 + 0.2 * z, 0.5), rate * (0.5 + z))
            for z in range(num_zones)]


def pollution_like(num_sensors: int = 4,
                   rate: float = 200) -> list[SubstreamSpec]:
    return [SubstreamSpec("pollution", (40.0 + 10 * s, 2.0), rate)
            for s in range(num_sensors)]


class StreamSource:
    """One source node emitting a mix of sub-streams each tick."""

    def __init__(self, specs: list[SubstreamSpec], seed: int = 0):
        self.specs = specs
        self.rng = np.random.default_rng(seed)
        # The pollution sensors' AR(1) levels, one per sub-stream.
        self._ar_state = np.array([p.params[0] for p in specs], np.float64)

    def tick(self) -> tuple[np.ndarray, np.ndarray]:
        """→ (values f32[n], strata i32[n]) for one tick."""
        vals, strs = [], []
        for i, sp in enumerate(self.specs):
            n = self.rng.poisson(sp.rate)
            if n == 0:
                continue
            if sp.dist == "gaussian":
                v = self.rng.normal(sp.params[0], sp.params[1], n)
            elif sp.dist == "poisson":
                v = self.rng.poisson(sp.params[0], n).astype(np.float64)
            elif sp.dist == "taxi":
                v = self.rng.lognormal(sp.params[0], sp.params[1], n)
            elif sp.dist == "pollution":
                self._ar_state[i] = (0.98 * self._ar_state[i]
                                     + 0.02 * sp.params[0]
                                     + self.rng.normal(0, sp.params[1]))
                v = self._ar_state[i] + self.rng.normal(0, 0.5, n)
            else:
                raise ValueError(f"unknown sub-stream kind {sp.dist!r}")
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
