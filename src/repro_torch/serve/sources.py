"""Subscribable stream sources for the serve plane.

The port's own copy of ``repro.serve.sources``.

A source is anything with the two-call lifecycle the executor drives
(modeled on the StreamingExecutor init/subscribe shape):

    source.subscribe(deliver)   # deliver(shard, values, strata)
    source.pump(now)            # emit this tick's items via deliver

``pump`` is the executor's clock edge — sources are passive between
pumps, so tests can inject a fake clock and get fully deterministic
runs. ``LateShardSource`` wraps any source to withhold its deliveries
for a tick range and release them afterwards: the executor publishes
the affected windows as *partial* (widened bound) and the released
items fold into the next window — the serve plane's straggler
semantics, reproducible on demand.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data import stream as stream_mod


class ConstantSource:
    """Deterministic constant-rate, constant-value source — the unit
    tests' workhorse: with sampling fraction 1.0 every published answer
    is exactly predictable."""

    def __init__(self, shard: int, rate: int, value: float = 1.0,
                 stratum: int = 0):
        self.shard = int(shard)
        self.rate = int(rate)
        self.value = float(value)
        self.stratum = int(stratum)
        self._deliver = None

    def subscribe(self, deliver):
        self._deliver = deliver

    def pump(self, now: float):
        if self._deliver is None or self.rate == 0:
            return
        self._deliver(self.shard,
                      np.full(self.rate, self.value, np.float32),
                      np.full(self.rate, self.stratum, np.int32))


class SyntheticSource:
    """Adapts a ``data.stream.StreamSource`` (the paper's §V synthetic
    workloads) to the subscribe/pump lifecycle, feeding one shard."""

    def __init__(self, shard: int, specs=None, seed: int = 0,
                 source: stream_mod.StreamSource | None = None):
        self.shard = int(shard)
        self._src = source or stream_mod.StreamSource(
            specs if specs is not None else stream_mod.paper_gaussian(),
            seed=seed)
        self._deliver = None

    def subscribe(self, deliver):
        self._deliver = deliver

    def pump(self, now: float):
        if self._deliver is None:
            return
        values, strata = self._src.tick()
        if values.size:
            self._deliver(self.shard, values, strata)


class LateShardSource:
    """Straggler injection: buffers the wrapped source's deliveries for
    pump ticks in ``[start_tick, end_tick)`` and releases the backlog on
    the first pump at/after ``end_tick`` (before that tick's own items,
    preserving arrival order)."""

    def __init__(self, source, start_tick: int, end_tick: int):
        if not 0 <= start_tick < end_tick:
            raise ValueError(f"need 0 <= start_tick < end_tick, got "
                             f"[{start_tick}, {end_tick})")
        self._src = source
        self.start_tick = int(start_tick)
        self.end_tick = int(end_tick)
        self._tick = 0
        self._held: list = []
        self._deliver = None

    def subscribe(self, deliver):
        self._deliver = deliver
        self._src.subscribe(self._intercept)

    def _intercept(self, shard, values, strata):
        if self.start_tick <= self._tick < self.end_tick:
            self._held.append((shard, values, strata))
        else:
            self._deliver(shard, values, strata)

    def pump(self, now: float):
        if self._tick >= self.end_tick and self._held:
            for shard, values, strata in self._held:
                self._deliver(shard, values, strata)
            self._held.clear()
        self._src.pump(now)
        self._tick += 1
