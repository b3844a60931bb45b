"""Host span tracer with Chrome/Perfetto export.

The port's own copy of ``repro.obs.trace``. Context-manager spans record
their start and end, the span that opened them, the epoch they belong
to and their metadata into a bounded ring buffer. The span names:

* the drivers: ``ingest`` (host-side epoch batch staging),
  ``epoch_dispatch`` (the epoch call, asynchronous on the card),
  ``block_until_ready`` (the device→host read of the epoch's outputs);
* inside ``CompiledPipeline.run_epoch``: ``run_epoch`` (the whole call;
  it opens an epoch, whose id every span under it carries),
  ``ingest_copy`` (the ingest's move to the device; meta ``bytes`` and
  the counter ``ingest_bytes``), ``tick_read`` (``int(state.tick)``, the
  one place the call waits on the device), ``priorities`` (the epoch's
  draws, every level at once) and ``tick`` (one tick function call; meta
  ``t``);
* inside a tick: ``level_tick`` (one ``fused_level_tick`` call, a
  non-root level of ``pallas_fused``; meta ``nodes``, ``slots``,
  ``strata``, and on the card the kernel's regime at those strata from
  ``csrc/fused_level_tick.cu``: ``digit_bits``, ``radix_passes``,
  ``moment_windows``).

When it records: a tracer records while it is enabled or while a
``torch.profiler`` is recording. Otherwise ``span()`` hands back one
shared no-op context: no clock read, no ``record_function``, nothing
appended. The process-wide tracer (:func:`get_tracer`) starts disabled;
the drivers switch it on where they report it (``--trace``,
telemetry), and a profiler's window records it by itself.

Its clock: spans are stamped by ``time.time_ns()``, the unix clock the
profiler's Chrome export uses (``ts`` µs after ``baseTimeNanoseconds``),
so the ring buffer and the profiler's events differ by one constant of a
few µs. Each span also opens a ``torch.profiler.record_function`` range
of its name, so under ``torch.profiler.profile`` it lines up with the
card's kernels.

:meth:`SpanTracer.chrome_trace` / :meth:`SpanTracer.save` write JSON
that loads in ``chrome://tracing`` and https://ui.perfetto.dev.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from typing import NamedTuple

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

# What ``span()`` returns while nothing records; ``nullcontext`` keeps no
# state, so one instance serves every call.
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    t0: int            # unix clock, ns (time.time_ns)
    t1: int
    depth: int         # nesting depth at open time (0 = top level)
    tid: int
    meta: dict
    id: int            # unique within the tracer
    parent: int | None     # the enclosing span's id (None at the top)
    epoch_id: int | None   # the id of the epoch span it runs under


class SpanTracer:
    """Bounded ring buffer of :class:`Span` records + per-name totals."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.durations: dict[str, float] = collections.defaultdict(float)
        self.calls: collections.Counter = collections.Counter()
        self.counters: collections.Counter = collections.Counter()
        self._ids = itertools.count(1)
        self._open = threading.local()   # per thread: [(id, epoch_id)]

    def span(self, name: str, **meta):
        """A context that records one span of ``name`` (see the module
        doc for when). It yields the span's metadata dict, for what is
        known only inside the span, or ``None`` where nothing records."""
        if not (self.enabled or _profiler_enabled()):
            return _OFF
        return self._record(name, meta, False)

    def epoch_span(self, name: str, **meta):
        """As :meth:`span`, and the span opens an epoch: it and every span
        under it carry its id as ``epoch_id``."""
        if not (self.enabled or _profiler_enabled()):
            return _OFF
        return self._record(name, meta, True)

    @contextlib.contextmanager
    def _record(self, name: str, meta: dict, opens_epoch: bool):
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        parent, epoch_id = stack[-1] if stack else (None, None)
        sid = next(self._ids)
        if opens_epoch:
            epoch_id = sid
        depth = len(stack)
        stack.append((sid, epoch_id))
        with record_function(name):
            t0 = time.time_ns()
            try:
                yield meta
            finally:
                t1 = time.time_ns()
                stack.pop()
                self.events.append(Span(name, t0, t1, depth,
                                        threading.get_ident(), meta, sid,
                                        parent, epoch_id))
                self.durations[name] += (t1 - t0) * 1e-9
                self.calls[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        """Bump a named counter (exposed by the metrics layer) when spans
        would record."""
        if self.enabled or _profiler_enabled():
            self.counters[name] += n

    @contextlib.contextmanager
    def on(self, when: bool = True):
        """Enable the tracer for the ``with`` block when ``when`` holds;
        the state before it comes back after."""
        was = self.enabled
        self.enabled = was or bool(when)
        try:
            yield self
        finally:
            self.enabled = was

    def clear(self) -> None:
        self.events.clear()
        self.durations.clear()
        self.calls.clear()
        self.counters.clear()

    # ------------------------------------------------------------ export --
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON: complete 'X' events in µs on the unix
        clock, each with its span ``id``; ``args`` holds the metadata,
        the depth and, where there is one, the ``parent`` and the
        ``epoch_id``."""
        def args(ev: Span) -> dict:
            out = {**ev.meta, "depth": ev.depth}
            if ev.parent is not None:
                out["parent"] = ev.parent
            if ev.epoch_id is not None:
                out["epoch_id"] = ev.epoch_id
            return out

        events = [{
            "name": ev.name, "ph": "X", "cat": "repro",
            "ts": ev.t0 / 1e3, "dur": (ev.t1 - ev.t0) / 1e3,
            "pid": 0, "tid": ev.tid, "id": ev.id, "args": args(ev),
        } for ev in self.events]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def well_formed(self) -> bool:
        """Spans form a proper tree per thread: every event either nests
        inside its enclosing span or is disjoint from its siblings."""
        per_tid: dict[int, list[Span]] = collections.defaultdict(list)
        for ev in sorted(self.events, key=lambda e: e.t0):
            per_tid[ev.tid].append(ev)
        for evs in per_tid.values():
            stack: list[Span] = []
            # events are recorded at close time; replay by open time and
            # check containment against the enclosing span
            for ev in evs:
                while stack and stack[-1].t1 <= ev.t0:
                    stack.pop()
                if stack and not (stack[-1].t0 <= ev.t0
                                  and ev.t1 <= stack[-1].t1):
                    return False
                stack.append(ev)
        return True


_GLOBAL: SpanTracer | None = None
_LOCK = threading.Lock()


def get_tracer() -> SpanTracer:
    """The process-wide default tracer (created on first use, disabled:
    it records under a profiler, or where a driver enables it)."""
    global _GLOBAL
    if _GLOBAL is None:
        with _LOCK:
            if _GLOBAL is None:
                _GLOBAL = SpanTracer(enabled=False)
    return _GLOBAL


def span(name: str, **meta):
    """``with span("epoch_dispatch"): ...`` on the default tracer."""
    return get_tracer().span(name, **meta)
