"""The always-on streaming executor in front of a compiled pipeline.

The port of ``repro.serve.executor``. ``StreamingExecutor`` turns
``repro_torch.api.CompiledPipeline`` into a service with the classic
streaming lifecycle (init → subscribe → pump → stop), on the pipeline's
device (the CUDA card by default; nothing falls back to the CPU):

* ``start(pipeline, sources)`` subscribes every source's deliveries into
  per-shard bounded queues (``serve.queues``; shard i feeds level-0
  node i).
* ``pump()`` is one tick: sources emit, queues batch-drain
  (``get_many``), items stage into the active host buffer
  (``serve.staging``), and the straggler monitor scores each shard's
  arrival lag against its rolling deadline.
* Every ``epoch_ticks`` pumps, the staged epoch dispatches to the
  device. Kernel launches are asynchronous, so the NEXT epoch's ingest
  may overlap the epoch still running on the device; the executor
  measures the realized overlap (time spent ingesting while a dispatch
  was not yet ready ÷ total ingest time) rather than claiming it. A
  dispatch is ready when a CUDA event recorded on the device's current
  stream after it has completed (always, on the CPU). ``run_epoch``
  reads the state's tick back and copies the staged set from pageable
  memory, each of which waits for the epoch before, so the overlap a
  card shows may be near 0.
* Window publication is straggler-tolerant (``serve.windows``): per
  tick the executor computes the Eq. 9 arrived-weight fraction α —
  arrived items for on-time shards, the shard's EWMA rate as the
  expected-but-missing weight for late ones, plus a virtual absent
  shard carrying this tick's queue drops/truncations — through
  ``StragglerMonitor.calibrate`` (``runtime.straggler.
  calibrate_weights``). α < 1 publishes a *partial* window with
  rescaled linear estimates and 1/α-widened bounds; the late items stay
  queued and fold into the next window.
* ``stop()`` drains: queues empty through extra (source-less) ticks,
  a final short epoch flushes the staged remainder, the last dispatch
  collects. After ``stop()`` no queue holds items — pinned in tests.

Determinism: the epoch PRNG key is ``prng.fold_in(pipeline.default_key,
epoch_index)`` (the reference's keys, bit for bit), sources are passive
between pumps, and the clock is injectable — a fake clock plus
deterministic sources reproduces a run bit-for-bit, and the reference
executor's run too.
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.obs.telemetry import StragglerMonitor
from repro_torch.serve.queues import POLICIES, BoundedShardQueue
from repro_torch.serve.staging import DoubleBuffer
from repro_torch.serve.windows import PublishedWindow, WindowPublisher


class _Pending(NamedTuple):
    """One in-flight dispatched epoch awaiting collection."""

    wa: Any              # WindowAnswers (device tensors, possibly in flight)
    ready: Any           # torch.cuda.Event after the dispatch, or None (CPU)
    base_tick: int       # global tick of the epoch's first row
    dispatched: float


class StreamingExecutor:
    """See module doc. Construct once, ``start`` per stream session."""

    def __init__(self, *, epoch_ticks: int = 8, width: int = 256,
                 queue_capacity: int = 4096, policy: str = "block",
                 max_records: int | None = None, clock=time.monotonic,
                 straggler_cfg=None, rate_ewma: float = 0.2,
                 seed: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown backpressure policy {policy!r}; "
                             f"valid: {POLICIES}")
        self.epoch_ticks = int(epoch_ticks)
        self.width = int(width)
        self.queue_capacity = int(queue_capacity)
        self.policy = policy
        self.max_records = int(max_records or width)
        self.clock = clock
        self._straggler_cfg = straggler_cfg
        self.rate_ewma = float(rate_ewma)
        self.seed = int(seed)
        self._running = False
        self.published: list[PublishedWindow] = []

    # ----------------------------------------------------------- start --
    def start(self, pipeline, sources, budgets=None,
              warmup: bool = True) -> "StreamingExecutor":
        if self._running:
            raise RuntimeError("executor already started — stop() first")
        self._pipeline = pipeline
        self._budgets = budgets
        self._n_shards = int(pipeline.fanin[0])
        if warmup:
            # Run one epoch on a throwaway state BEFORE the service clock
            # starts: the kernels build (and load) at their first launch,
            # and the first window's latency would be charged for it.
            scratch, wa = pipeline.run_epoch(
                pipeline.init(), pipeline.default_key,
                np.zeros((self.epoch_ticks, self._n_shards, self.width),
                         np.float32),
                np.zeros((self.epoch_ticks, self._n_shards, self.width),
                         np.int32),
                np.zeros((self.epoch_ticks, self._n_shards), np.int32),
                budgets)
            wa.ok.cpu()
            del scratch, wa
        self._sources = list(sources)
        self._queues = [BoundedShardQueue(self.queue_capacity, self.policy,
                                          seed=self.seed + i)
                        for i in range(self._n_shards)]
        self._staging = DoubleBuffer(self.epoch_ticks, self._n_shards,
                                     self.width)
        self._monitor = StragglerMonitor(self._n_shards,
                                         self._straggler_cfg)
        self._publisher = WindowPublisher(pipeline)
        self._state = pipeline.init()
        for src in self._sources:
            src.subscribe(self._deliver)
        now = self.clock()
        self._last_delivery = np.full(self._n_shards, now, np.float64)
        self._rate = np.zeros(self._n_shards, np.float64)
        self._t = 0                    # tick index within current epoch
        self._global_tick = 1          # matches PipelineState.tick init
        self._epoch = 0
        self._last_published_tick = 0
        self._meta: dict[int, dict] = {}
        self._pending: _Pending | None = None
        self._ingest_seconds = 0.0
        self._overlap_seconds = 0.0
        self.published = []
        self._running = True
        return self

    def _deliver(self, shard: int, values, strata):
        if not self._running:
            raise RuntimeError("delivery to a stopped executor")
        self._queues[shard % self._n_shards].put(values, strata,
                                                 self.clock())

    # ------------------------------------------------------------ pump --
    def pump(self) -> list[PublishedWindow]:
        """One tick; returns the windows published during this pump
        (possibly none — publication happens at epoch boundaries)."""
        return self._tick(drain=False)

    def run(self, ticks: int) -> list[PublishedWindow]:
        """``ticks`` pumps back to back; returns what they published."""
        n0 = len(self.published)
        for _ in range(int(ticks)):
            self._tick(drain=False)
        return self.published[n0:]

    def _tick(self, *, drain: bool) -> list[PublishedWindow]:
        if not self._running:
            raise RuntimeError("executor is not started")
        n0 = len(self.published)
        t_start = self.clock()
        device_busy = (self._pending is not None
                       and not _is_ready(self._pending.ready))
        drops0 = sum(q.items_dropped for q in self._queues)
        trunc0 = self._staging.truncated_total
        if not drain:
            for src in self._sources:
                src.pump(t_start)
        arrived = np.zeros(self._n_shards, np.int64)
        for shard, q in enumerate(self._queues):
            values, strata, arrivals = q.get_many(self.max_records)
            arrived[shard] = values.size
            if values.size:
                self._last_delivery[shard] = t_start
                self._staging.stage(self._t, shard, values, strata,
                                    arrival=float(arrivals.min()))
        now = self.clock()
        shed = ((sum(q.items_dropped for q in self._queues) - drops0)
                + (self._staging.truncated_total - trunc0))
        if drain:
            present = np.ones(self._n_shards, bool)
        else:
            present = self._monitor.observe(now - self._last_delivery)
            present = present | (arrived > 0)
        mask = arrived > 0
        fresh = mask & (self._rate == 0.0)
        self._rate = np.where(
            mask, (1.0 - self.rate_ewma) * self._rate
            + self.rate_ewma * arrived, self._rate)
        self._rate = np.where(fresh, arrived, self._rate)
        self._meta[self._global_tick] = self._tick_alpha(
            arrived, present, shed)
        self._t += 1
        self._global_tick += 1
        if self._t == self.epoch_ticks:
            self._flush(self.epoch_ticks)
        dt = self.clock() - t_start
        self._ingest_seconds += dt
        if device_busy:
            self._overlap_seconds += dt
        return self.published[n0:]

    def _tick_alpha(self, arrived, present, shed: int) -> dict:
        """Eq. 9 arrived-weight accounting for one tick: on-time shards
        weigh what they delivered, late shards weigh their EWMA expected
        rate, and a virtual absent shard carries this tick's shed items
        (queue drops + staging truncation). ``calibrate_weights`` scales
        the arrived weights by 1/α — the same factor later widens the
        window's bounds."""
        weight = np.where(present, arrived.astype(np.float64), self._rate)
        w_ext = np.append(weight, float(shed))
        p_ext = np.append(present, shed == 0)
        calibrated = self._monitor.calibrate(w_ext, p_ext)
        live = p_ext & (w_ext > 0)
        kept = float(w_ext[p_ext].sum())
        total = float(w_ext.sum())
        if live.any() and kept > 0.0:
            widen = float((calibrated[live] / w_ext[live]).max())
        else:
            widen = 1.0
        return {
            "kept": kept, "total": total, "widen": widen,
            "late": int((~present).sum()),
            "first_arrival": self._staging.first_arrival(self._t),
        }

    # ------------------------------------------------- epoch lifecycle --
    def _flush(self, n_ticks: int):
        # Always dispatch a full epoch_ticks epoch: a short final epoch
        # (stop() mid-epoch) keeps its zeroed tail rows, which flush empty
        # root windows (ok=False, no published rows), as the reference's
        # one compiled epoch program does.
        staged = self._staging.swap()
        self._state = self._monitor.fold_into(self._state)
        key = prng.fold_in(self._pipeline.default_key, self._epoch)
        self._state, wa = self._pipeline.run_epoch(
            self._state, key, staged.values, staged.strata, staged.counts,
            self._budgets)
        prev, self._pending = self._pending, _Pending(
            wa=wa, ready=_record(self._pipeline.device),
            base_tick=self._global_tick - n_ticks,
            dispatched=self.clock())
        if prev is not None:
            self._collect(prev)
        self._epoch += 1
        self._t = 0
        # Padded empty ticks advanced the pipeline's tick counter past
        # the pump count; follow it so later rows keep matching metas.
        self._global_tick += self.epoch_ticks - n_ticks

    def _collect(self, pending: _Pending):
        rows = self._pipeline.rows(pending.wa)   # blocks until ready
        now = self.clock()
        for row in rows:
            tick = int(row["tick"])
            metas = [self._meta.pop(t) for t in
                     range(self._last_published_tick + 1, tick + 1)
                     if t in self._meta]
            kept = sum(m["kept"] for m in metas)
            total = sum(m["total"] for m in metas)
            alpha = kept / total if total > 0.0 else 1.0
            first_arrival = min((m["first_arrival"] for m in metas),
                                default=np.inf)
            self.published.append(self._publisher.publish(
                row, alpha=alpha, partial=alpha < 1.0 - 1e-9,
                publish_time=now, first_arrival=first_arrival))
            self._last_published_tick = tick

    # ------------------------------------------------------------ stop --
    def stop(self) -> dict:
        """Drain and shut down: empty every queue through source-less
        ticks, flush the staged remainder as one short epoch, collect
        the last dispatch. Returns ``stats()``."""
        if not self._running:
            raise RuntimeError("executor is not started")
        # Each drain tick removes up to max_records per queue, so the
        # loop terminates within depth/max_records ticks; the guard only
        # trips on a bookkeeping bug.
        limit = 2 * (self.queue_capacity // max(self.max_records, 1)
                     + self.epoch_ticks + 2)
        for _ in range(limit):
            if not any(q.depth for q in self._queues):
                break
            self._tick(drain=True)
        else:
            raise RuntimeError("drain did not converge — queue depths "
                               f"{[q.depth for q in self._queues]}")
        if self._t > 0:
            self._flush(self._t)
        if self._pending is not None:
            self._collect(self._pending)
            self._pending = None
        self._running = False
        return self.stats()

    # ------------------------------------------------------------ obs --
    @property
    def state(self):
        """The live pipeline state (telemetry snapshots etc.). Do not
        mutate: ``run_epoch`` consumes it."""
        return self._state

    @property
    def monitor(self) -> StragglerMonitor:
        """The straggler monitor (running late/widened totals for the
        metrics plane)."""
        return self._monitor

    @property
    def overlap_fraction(self) -> float:
        """Measured ingest/dispatch overlap: share of ingest wall time
        spent while a dispatched epoch was still computing."""
        if self._ingest_seconds <= 0.0:
            return 0.0
        return self._overlap_seconds / self._ingest_seconds

    def window_latencies(self) -> np.ndarray:
        return np.asarray([w.latency for w in self.published
                           if w.latency > 0.0], np.float64)

    def stats(self) -> dict:
        queues = [q.stats() for q in getattr(self, "_queues", [])]
        lat = self.window_latencies()
        partial = sum(1 for w in self.published if w.partial)
        return {
            "policy": self.policy,
            "running": self._running,
            "epochs": getattr(self, "_epoch", 0),
            "queue_depth": [q["depth"] for q in queues],
            "queue_high_watermark": max(
                (q["high_watermark"] for q in queues), default=0),
            "queue_items_in": sum(q["items_in"] for q in queues),
            "queue_items_out": sum(q["items_out"] for q in queues),
            "queue_items_dropped": sum(q["items_dropped"] for q in queues),
            "queue_deferred": sum(q["deferred"] for q in queues),
            "staged_items": getattr(self._staging, "staged_total", 0)
            if hasattr(self, "_staging") else 0,
            "truncated_items": self._staging.truncated_total
            if hasattr(self, "_staging") else 0,
            "overlap_fraction": self.overlap_fraction,
            "ingest_seconds": self._ingest_seconds
            if hasattr(self, "_ingest_seconds") else 0.0,
            "windows_published": len(self.published),
            "windows_partial": partial,
            "latency_p50": float(np.percentile(lat, 50)) if lat.size else 0.0,
            "latency_p99": float(np.percentile(lat, 99)) if lat.size else 0.0,
        }


def _record(device: torch.device):
    """A CUDA event recorded on ``device``'s current stream, after the
    dispatch just queued there; ``None`` on the CPU, where a dispatch
    has ended when it returns."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _is_ready(ready) -> bool:
    """Whether the dispatch behind ``_record``'s event has completed."""
    return ready is None or bool(ready.query())
