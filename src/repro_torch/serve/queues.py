"""Bounded per-shard ingest queues with an explicit backpressure policy.

The port's own copy of ``repro.serve.queues`` (numpy only; the degrade
policy draws from the same seeded generator, so the same items go).

The serve plane's answer to "what happens when data arrives faster than
the device drains it": every edge shard owns ONE bounded queue between
its source subscription and the staging buffers, and the queue's policy
decides who pays when it fills:

    block        refuse the overflow — rejected items never enter the
                 queue and are counted ``deferred`` (the producer still
                 holds them; a Kafka-style consumer would simply not
                 advance its offset).
    drop_oldest  evict the oldest queued items to make room for the new
                 ones — freshest-data-wins, evictions counted
                 ``items_dropped``.
    degrade      drop each INCOMING item with probability depth/capacity
                 (deterministic per-queue RNG) — graceful load shedding
                 that sheds more as the queue fills, drops counted
                 ``items_dropped``.

Every drop is counted so the published bound stays honest: the executor
folds ``items_dropped`` into the Eq. 9 arrived-weight fraction α, so a
window that shed load publishes with a widened bound instead of a
silently optimistic one.

Accounting invariant:

    items_in == items_out + items_dropped + depth

(``deferred`` counts offers that never entered, so it sits outside the
identity on purpose.)
"""
from __future__ import annotations

import collections

import numpy as np

POLICIES = ("block", "drop_oldest", "degrade")


class BoundedShardQueue:
    """One shard's bounded ingest queue (see module doc for policies)."""

    def __init__(self, capacity: int, policy: str = "block", seed: int = 0):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        if policy not in POLICIES:
            raise ValueError(f"unknown backpressure policy {policy!r}; "
                             f"valid: {POLICIES}")
        self.capacity = int(capacity)
        self.policy = policy
        self._q: collections.deque = collections.deque()
        self._rng = np.random.default_rng(seed)
        self.items_in = 0
        self.items_out = 0
        self.items_dropped = 0
        self.deferred = 0
        self.high_watermark = 0

    # ------------------------------------------------------------- put --
    def put(self, values, strata, now: float) -> int:
        """Offer a batch of (value, stratum) items stamped with arrival
        time ``now``; returns the number actually enqueued."""
        values = np.asarray(values, np.float32)
        strata = np.asarray(strata, np.int32)
        offered = int(values.size)
        if offered == 0:
            return 0
        if self.policy == "block":
            take = min(offered, self.capacity - len(self._q))
            self.deferred += offered - take
            self.items_in += take
            for i in range(take):
                self._q.append((float(values[i]), int(strata[i]), now))
            accepted = take
        elif self.policy == "drop_oldest":
            self.items_in += offered
            for i in range(offered):
                self._q.append((float(values[i]), int(strata[i]), now))
            while len(self._q) > self.capacity:
                self._q.popleft()
                self.items_dropped += 1
            accepted = offered
        else:  # degrade
            self.items_in += offered
            p_drop = len(self._q) / self.capacity
            keep = self._rng.random(offered) >= p_drop
            self.items_dropped += int(offered - keep.sum())
            for i in np.flatnonzero(keep):
                self._q.append((float(values[i]), int(strata[i]), now))
            while len(self._q) > self.capacity:
                self._q.popleft()
                self.items_dropped += 1
            accepted = int(keep.sum())
        self.high_watermark = max(self.high_watermark, len(self._q))
        return accepted

    # -------------------------------------------------------- get_many --
    def get_many(self, max_records: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Kafka-``getmany``-style batched drain: up to ``max_records``
        items in FIFO order → ``(values f32[n], strata i32[n],
        arrivals f64[n])``."""
        n = min(int(max_records), len(self._q))
        values = np.empty(n, np.float32)
        strata = np.empty(n, np.int32)
        arrivals = np.empty(n, np.float64)
        for i in range(n):
            values[i], strata[i], arrivals[i] = self._q.popleft()
        self.items_out += n
        return values, strata, arrivals

    # ------------------------------------------------------ accounting --
    @property
    def depth(self) -> int:
        return len(self._q)

    @property
    def accounting_ok(self) -> bool:
        """The drop-accounting law: every offered-and-admitted item is
        either drained, dropped, or still queued."""
        return self.items_in == (self.items_out + self.items_dropped
                                 + self.depth)

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "policy": self.policy,
            "depth": self.depth,
            "high_watermark": self.high_watermark,
            "items_in": self.items_in,
            "items_out": self.items_out,
            "items_dropped": self.items_dropped,
            "deferred": self.deferred,
        }
