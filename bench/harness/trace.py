"""Reduce a ``torch.profiler`` trace to what the per-layer readers need.

The traced window runs under ``torch.profiler.profile`` with CPU and
CUDA activities; the harness marks its own calls with
``record_function`` spans (``bench.run_epoch``, ``bench.readback``). The
Chrome trace is read back once: device operations (kernels, copies,
fills) with their intervals, the harness's spans, and the host
operations, so that an idle stretch of the device can be named by what
the host was doing then.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "fill"}
SPAN_PREFIX = "bench."


@dataclass
class DeviceOp:
    name: str
    kind: str          # kernel | copy | fill
    start: float       # seconds, trace clock
    end: float


@dataclass
class Trace:
    ops: list = field(default_factory=list)       # DeviceOp
    spans: list = field(default_factory=list)     # (name, start, end)
    host_ops: list = field(default_factory=list)  # (name, start, end)
    window: tuple = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i].strip()
            break
    return name[:160]


def read(prof) -> Trace:
    """The profiler's events, by way of its Chrome trace (written to and
    deleted from ``TMPDIR``)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    tr = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        start = float(ev["ts"]) * 1e-6
        end = start + float(ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        if cat in DEVICE_CATS:
            tr.ops.append(DeviceOp(name, DEVICE_CATS[cat], start, end))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            tr.spans.append((name, start, end))
        elif cat == "cpu_op":
            tr.host_ops.append((name, start, end))
    if tr.spans:
        tr.window = (min(s for _, s, _ in tr.spans),
                     max(e for _, _, e in tr.spans))
    tr.ops.sort(key=lambda o: o.start)
    return tr


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Merged intervals, clipped to ``[lo, hi]``."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(tr: Trace, kinds=("kernel", "copy", "fill")) -> float:
    """Seconds of the window in which an operation of ``kinds`` ran."""
    lo, hi = tr.window
    return sum(e - s for s, e in union(
        [(o.start, o.end) for o in tr.ops if o.kind in kinds], lo, hi))


def in_window(tr: Trace, op: DeviceOp) -> bool:
    return tr.window[0] <= op.start < tr.window[1]


def _innermost(items, starts, t: float, reach: int = 256):
    """The latest-started of ``items`` (sorted by start) that is still
    under way at ``t``: under nesting, the innermost one."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if items[j][2] >= t:
            return items[j]
    return None


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by what the host was doing (the harness's span and, inside it,
    the host operation under way in the middle of each gap)."""
    lo, hi = tr.window
    per_op: dict[str, float] = {}
    for o in tr.ops:
        if in_window(tr, o):
            key = short_name(o.name)
            per_op[key] = per_op.get(key, 0.0) + (o.end - o.start)
    busy_iv = union([(o.start, o.end) for o in tr.ops], lo, hi)
    gaps, t = [], lo
    for s, e in busy_iv:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    host = sorted(tr.host_ops, key=lambda h: h[1])
    host_starts = [h[1] for h in host]
    spans = sorted(tr.spans, key=lambda h: h[1])
    span_starts = [h[1] for h in spans]
    per_gap: dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        span = _innermost(spans, span_starts, mid)
        op = _innermost(host, host_starts, mid)
        label = span[0] if span else "between calls"
        if op is not None:
            label = f"{label} / {op[0]}"
        per_gap[label] = per_gap.get(label, 0.0) + (e - s)

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": top_of(per_op), "idle_gaps": top_of(per_gap)}
