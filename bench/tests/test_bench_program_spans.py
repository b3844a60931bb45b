"""The readers of the program's spans (``harness/program_spans.py`` and
the six metrics that use it) on a synthetic trace: device operations,
host operations and the harness's spans on the trace's clock, and the
program's ring buffer on the unix clock a whole number of seconds away,
with every reading counted by hand."""
from __future__ import annotations

import pytest

from harness import cell, program_spans, registry, trace
from repro_torch.obs import trace as obs_trace

BASE_S = 1_790_000_000          # the trace's clock is the unix clock less this
TICKS = 2                       # windows an epoch
EPOCHS = (1.0, 2.0)             # each epoch's start on the trace's clock, s


def _ns(t: float) -> int:
    return round(t * 1e9) + BASE_S * 10**9


def _ring(end_skew=(0.0, 0.0), drop_last=False):
    """The program's spans of both epochs, as the tracer records them."""
    events, sid = [], 0
    for k, e in enumerate(EPOCHS):
        sid += 1
        root = sid
        kids = [("ingest_copy", e + 0.001, e + 0.011),
                ("tick_read", e + 0.012, e + 0.013),
                ("priorities", e + 0.020, e + 0.050),
                ("tick", e + 0.100, e + 0.200),
                ("tick", e + 0.250, e + 0.350)]
        for name, s, t in kids:
            sid += 1
            events.append(obs_trace.Span(name, _ns(s), _ns(t), 1, 1, {},
                                         sid, root, root))
        if not (drop_last and k == len(EPOCHS) - 1):
            events.append(obs_trace.Span(
                "run_epoch", _ns(e + 0.0001),
                _ns(e + 0.4999 - end_skew[k]), 0, 1, {"ticks": TICKS}, root,
                None, root))
    return events


def _trace():
    tr = trace.Trace()
    for e in EPOCHS:
        tr.spans += [("bench.run_epoch", e, e + 0.5),
                     ("bench.readback", e + 0.5, e + 0.6)]
        tr.ops += [
            trace.DeviceOp("Memcpy HtoD", "copy", e + 0.001, e + 0.011),
            # 20 of priorities' 30 ms busy
            trace.DeviceOp("k_prio", "kernel", e + 0.020, e + 0.040),
            # the first tick wholly busy, the second half idle
            trace.DeviceOp("k_tick", "kernel", e + 0.100, e + 0.200),
            trace.DeviceOp("k_tick", "kernel", e + 0.300, e + 0.400),
            trace.DeviceOp("Memset", "fill", e + 0.420, e + 0.430)]
        tr.host_ops += [
            ("aten::before", e + 0.0195, e + 0.0199),      # before the span
            ("aten::a", e + 0.021, e + 0.030),
            ("aten::a_inner", e + 0.022, e + 0.025),        # nested: not counted
            ("aten::b", e + 0.031, e + 0.035),
            ("aten::c", e + 0.040, e + 0.049),
            ("aten::t1", e + 0.101, e + 0.150),
            ("aten::t1_inner", e + 0.102, e + 0.103),
            ("aten::t2", e + 0.151, e + 0.199),
            ("aten::t3", e + 0.251, e + 0.300),
            ("aten::t4", e + 0.301, e + 0.349),
            ("aten::after", e + 0.360, e + 0.370)]          # after the ticks
    tr.window = (1.0, 2.6)
    return tr


@pytest.fixture
def ring(monkeypatch):
    """Installs a default tracer holding the given records."""
    def install(events):
        tr = obs_trace.SpanTracer(enabled=False)
        tr.events.extend(events)
        monkeypatch.setattr(obs_trace, "_GLOBAL", tr)
    return install


def _ctx(tr=None):
    windows = TICKS * len(EPOCHS)
    return cell.Context(_trace() if tr is None else tr,
                        {"dispatch_s": [0.5] * len(EPOCHS),
                         "readback_s": [0.1] * len(EPOCHS)},
                        {}, windows, None)


# By hand, over 2 epochs of 2 windows in a window of 1.6 s:
# ingest_copy 10 ms an epoch; ticks 200 ms an epoch; priorities hold 3
# outermost operations an epoch, the ticks 4; priorities idle 10 ms an
# epoch, the ticks 50 ms.
EXPECTED = {"ingest_copy_ms": 2 * 10.0 / 4,
            "tick_ms": 2 * 200.0 / 4,
            "priorities_ops_per_window": 2 * 3 / 4,
            "tick_ops_per_window": 2 * 4 / 4,
            "priorities_idle_share": 100 * 2 * 0.010 / 1.6,
            "tick_idle_share": 100 * 2 * 0.050 / 1.6}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_metric_reads_its_hand_count(ring, name):
    ring(_ring())
    got = registry.metric_reader(name).read(_ctx())
    assert got == pytest.approx(EXPECTED[name], rel=1e-9, abs=1e-9)


def test_spans_land_on_the_trace_clock(ring):
    ring(_ring(end_skew=(0.0, 0.00015)))       # 0.15 ms: still aligned
    ctx = _ctx()
    sp = program_spans.spans(ctx)
    prio = [(s, e) for n, s, e, _ in sp if n == "priorities"]
    assert prio == [pytest.approx((e + 0.020, e + 0.050), abs=1e-9)
                    for e in EPOCHS]
    assert program_spans.spans(ctx) is sp      # read once a run


@pytest.mark.parametrize("case", ["spread", "counts", "no_run_epoch",
                                  "no_device_ops", "outside"])
def test_nothing_to_read(ring, case):
    events = _ring()
    tr = None
    if case == "spread":
        # the pairs' offsets 1 ms apart: their quartiles 0.5 ms apart
        events = _ring(end_skew=(0.0, 0.001))
    elif case == "counts":
        events = _ring(drop_last=True)
    elif case == "no_run_epoch":
        events = [e for e in events if e.name != "run_epoch"]
    elif case == "no_device_ops":
        tr = _trace()
        tr.ops = []
    elif case == "outside":
        # a run_epoch longer than its bench.run_epoch cannot be placed
        events = [e._replace(t0=e.t0 - 10**6) if e.name == "run_epoch"
                  else e for e in events]
    ring(events)
    ctx = _ctx(tr)
    assert program_spans.spans(ctx) is None
    for name in EXPECTED:
        assert registry.metric_reader(name).read(ctx) is None


def test_outermost_keeps_operations_not_inside_an_earlier_one():
    ops = [("a", 0.0, 1.0), ("a_in", 0.0, 0.5), ("b", 0.5, 0.9),
           ("c", 1.0, 2.0), ("d", 1.5, 2.5)]
    assert [n for n, _, _ in program_spans.outermost(ops)] == ["a", "c", "d"]
