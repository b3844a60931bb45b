"""The program's own spans, on the traced window's clock.

While a ``torch.profiler`` records, ``repro_torch``'s default tracer
(``repro_torch.obs.trace.get_tracer()``) keeps every span the program
opens in its ring buffer: in a traced run, exactly the window's epochs
(``run_epoch`` → ``ingest_copy``, ``tick_read``, ``priorities``, ``tick``
× T). It stamps them on the unix clock, which the profiler's Chrome
export shares up to a constant. ``trace.read`` keeps only the harness's
``bench.`` spans of that export, so a reader of a program span takes it
from here:

    from harness import program_spans

    def read(ctx):
        return program_spans.host_ms(ctx, "ingest_copy")

``spans(ctx)`` gives every program span as ``(name, start, end, meta)``
in seconds on ``ctx.trace``'s clock (or ``None``); ``host_ms``,
``ops_per_window`` and ``idle_share`` read one span name a window.

The alignment: the program's k-th ``run_epoch`` runs inside the
harness's k-th ``bench.run_epoch``. The export's ``ts`` are µs after its
``baseTimeNanoseconds``, a whole number of seconds on the unix clock
(torch 2.11 with CUDA, 2.13 on the CPU), so the trace's clock is the
ring buffer's less a whole number of seconds. Each pair's ends give that
offset to within the profiler's own work on leaving a range (tens of
µs; on entering one it grows with the operations recorded before it,
so the starts are not used); their median, rounded to the second, is
the offset exactly. Operations then fall inside the spans that ran them
to the µs. There is nothing to read (``None``, and one line on standard
error says why) where the trace holds no device operation (a run on the
CPU), the program recorded no ``run_epoch`` (a program without these
spans), the counts of the two differ, the pairs' offsets spread (between
their quartiles) by more than ``MAX_SPREAD_S``, or a ``run_epoch`` so
placed does not lie inside its ``bench.run_epoch``.
"""
from __future__ import annotations

import bisect
import statistics
import sys

from harness import trace

MAX_SPREAD_S = 0.2e-3
_UNREAD = object()


def _program_events():
    """The program's default tracer's ring buffer."""
    from repro_torch.obs.trace import get_tracer

    return list(get_tracer().events)


def _note(msg: str) -> None:
    print(f"program spans: {msg}", file=sys.stderr)


def offset_spread(offsets) -> float:
    """The distance between the first and the third quartile of the
    per-epoch offsets (``statistics.quantiles``, inclusive): one epoch
    whose range the profiler was slow to leave does not move it."""
    if len(offsets) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(offsets, n=4, method="inclusive")
    return q3 - q1


def align(tr, events):
    """``(spans, offsets)``: the program's ``events`` (ring buffer records
    with ``name``, ``t0``, ``t1`` in unix ns and ``meta``) moved onto the
    clock of ``tr`` (a ``trace.Trace``), and each epoch's offset in s; or
    ``(None, reason)``."""
    if tr is None or not tr.ops:
        return None, "no device trace to align to"
    epochs = sorted((e for e in events if e.name == "run_epoch"),
                    key=lambda e: e.t0)
    bench = sorted((s, e) for n, s, e in tr.spans if n == "bench.run_epoch")
    if not epochs:
        return None, "the program recorded no run_epoch span"
    if len(epochs) != len(bench):
        return None, (f"{len(epochs)} run_epoch spans against "
                      f"{len(bench)} bench.run_epoch")
    offsets = [be - ev.t1 * 1e-9 for ev, (_, be) in zip(epochs, bench)]
    spread = offset_spread(offsets)
    if spread > MAX_SPREAD_S:
        return None, (f"per-epoch clock offsets spread by "
                      f"{spread * 1e6:.1f} us")
    shift_ns = round(statistics.median(offsets)) * 10**9

    def on_trace(t_ns: int) -> float:
        return (t_ns + shift_ns) * 1e-9

    if not all(bs <= on_trace(ev.t0) and on_trace(ev.t1) <= be
               for ev, (bs, be) in zip(epochs, bench)):
        return None, ("run_epoch falls outside bench.run_epoch on a "
                      "whole-second offset")
    spans = sorted(((e.name, on_trace(e.t0), on_trace(e.t1), dict(e.meta))
                    for e in events), key=lambda s: s[1])
    return spans, offsets


def spans(ctx):
    """The program's spans on ``ctx.trace``'s clock, read once a run:
    ``[(name, start, end, meta)]``, or ``None``."""
    cached = getattr(ctx, "_program_spans", _UNREAD)
    if cached is not _UNREAD:
        return cached
    out, info = align(getattr(ctx, "trace", None), _program_events())
    if out is None:
        _note(f"none read: {info}")
    else:
        run = sum(e - s for n, s, e, _ in out if n == "run_epoch")
        disp = sum(ctx.host.get("dispatch_s", []))
        _note(f"{len(info)} epochs; clock offsets spread "
              f"{offset_spread(info) * 1e6:.1f} us (quartiles), "
              f"{(max(info) - min(info)) * 1e6:.1f} us (range); run_epoch "
              f"{run * 1e3:.3f} ms against the harness's "
              f"{disp * 1e3:.3f} ms")
    ctx._program_spans = out
    return out


def intervals(ctx, name: str):
    """``[(start, end)]`` of the program's spans of ``name``, or
    ``None``."""
    sp = spans(ctx)
    if sp is None or not ctx.windows:
        return None
    iv = [(s, e) for n, s, e, _ in sp if n == name]
    return iv or None


def host_ms(ctx, name: str):
    """Host milliseconds a window inside the spans of ``name``."""
    iv = intervals(ctx, name)
    if iv is None:
        return None
    return 1e3 * sum(e - s for s, e in iv) / ctx.windows


def outermost(host_ops):
    """The host operations not inside an earlier one, by start."""
    out, reach = [], float("-inf")
    for name, s, e in sorted(host_ops, key=lambda h: (h[1], -h[2])):
        if e > reach:
            out.append((name, s, e))
            reach = e
    return out


def ops_per_window(ctx, name: str):
    """Outermost host operations a window that start inside the spans of
    ``name``."""
    iv = intervals(ctx, name)
    if iv is None:
        return None
    starts = [s for s, _ in iv]
    n = 0
    for _, s, _ in outermost(ctx.trace.host_ops):
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < iv[i][1]:
            n += 1
    return n / ctx.windows


def idle_share(ctx, name: str):
    """% of the traced window in which no kernel, copy or fill ran while
    the host was inside the spans of ``name``."""
    iv = intervals(ctx, name)
    if iv is None or ctx.trace.window_s <= 0:
        return None
    lo, hi = ctx.trace.window
    busy = trace.union([(o.start, o.end) for o in ctx.trace.ops], lo, hi)
    ends = [e for _, e in busy]
    idle = 0.0
    for s, e in trace.union(iv, lo, hi):
        idle += e - s
        j = bisect.bisect_right(ends, s)
        while j < len(busy) and busy[j][0] < e:
            idle -= min(busy[j][1], e) - max(busy[j][0], s)
            j += 1
    return 100.0 * idle / ctx.trace.window_s
