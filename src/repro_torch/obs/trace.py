"""Host span tracer with Chrome/Perfetto export.

The port's own copy of ``repro.obs.trace``. Context-manager spans record
monotonic wall time and metadata into a bounded ring buffer. The span
names the drivers emit:

* ``ingest``            — host-side epoch batch staging
* ``epoch_dispatch``    — the epoch call (asynchronous on the card)
* ``block_until_ready`` — the device→host read of the epoch's outputs

:meth:`SpanTracer.chrome_trace` / :meth:`SpanTracer.save` write JSON
that loads in ``chrome://tracing`` and https://ui.perfetto.dev. Each
span also opens a ``torch.profiler.record_function`` range, so under
``torch.profiler.profile`` it lines up with the card's kernels.

A process-wide default tracer (:func:`get_tracer`) keeps call sites to
one line — ``with span("epoch_dispatch"): ...`` — and a disabled
tracer's span is a no-op (one truthiness check).
"""
from __future__ import annotations

import collections
import json
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

from torch.profiler import record_function


class Span(NamedTuple):
    name: str
    t0: float          # perf_counter seconds
    t1: float
    depth: int         # nesting depth at open time (0 = top level)
    tid: int
    meta: dict


class SpanTracer:
    """Bounded ring buffer of :class:`Span` records + per-name totals."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.durations: dict[str, float] = collections.defaultdict(float)
        self.calls: collections.Counter = collections.Counter()
        self.counters: collections.Counter = collections.Counter()
        self._stack: list[str] = []

    @contextmanager
    def span(self, name: str, **meta):
        if not self.enabled:
            yield
            return
        depth = len(self._stack)
        self._stack.append(name)
        with record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self._stack.pop()
                self.events.append(Span(name, t0, t1, depth,
                                        threading.get_ident(), meta))
                self.durations[name] += t1 - t0
                self.calls[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        """Bump a named counter (exposed by the metrics layer)."""
        if self.enabled:
            self.counters[name] += n

    def clear(self) -> None:
        self.events.clear()
        self.durations.clear()
        self.calls.clear()
        self.counters.clear()
        self._stack.clear()

    # ------------------------------------------------------------ export --
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (complete 'X' events, µs timebase)."""
        events = [{
            "name": ev.name, "ph": "X", "cat": "repro",
            "ts": ev.t0 * 1e6, "dur": (ev.t1 - ev.t0) * 1e6,
            "pid": 0, "tid": ev.tid,
            "args": {**ev.meta, "depth": ev.depth},
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
                                  and ev.t1 <= stack[-1].t1 + 1e-9):
                    return False
                stack.append(ev)
        return True


_GLOBAL: SpanTracer | None = None
_LOCK = threading.Lock()


def get_tracer() -> SpanTracer:
    """The process-wide default tracer (created on first use)."""
    global _GLOBAL
    if _GLOBAL is None:
        with _LOCK:
            if _GLOBAL is None:
                _GLOBAL = SpanTracer()
    return _GLOBAL


def span(name: str, **meta):
    """``with span("epoch_dispatch"): ...`` on the default tracer."""
    return get_tracer().span(name, **meta)
