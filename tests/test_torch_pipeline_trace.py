"""The spans ``CompiledPipeline.run_epoch`` records, on the CPU.

Under ``torch.profiler`` one epoch leaves the tree ``run_epoch`` →
``ingest_copy``, ``tick_read``, ``priorities``, ``tick`` × T in the
default tracer's ring buffer, on the profiler's own clock up to one
constant; with the default tracer and no profiler it records nothing
and opens no ``record_function``; and tracing changes no answer and no
state bit.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.data import stream as S  # noqa: E402
from repro_torch.obs import trace as TT  # noqa: E402

TICKS = 3
CHILDREN = ["ingest_copy", "tick_read", "priorities"] + ["tick"] * TICKS


def _pipeline():
    spec = api.PipelineSpec(
        topology=api.TopologySpec(fanin=(4, 2, 1), capacity=256,
                                  num_strata=4),
        sampler=api.SamplerSpec(mode="whs", backend="pallas_fused",
                                allocation="fair", fraction=0.1),
        telemetry=api.TelemetrySpec(enabled=True), seed=5)
    return api.compile(spec, device="cpu")


def _ingest(seed=0):
    sources = [S.StreamSource(S.paper_gaussian(rates=(20,) * 4),
                              seed=seed + i) for i in range(8)]
    return S.batch_ingest(sources, TICKS, 4, 256)


@pytest.fixture
def tracer(monkeypatch):
    """A fresh default tracer, disabled as the process starts it."""
    tr = TT.SpanTracer(enabled=False)
    monkeypatch.setattr(TT, "_GLOBAL", tr)
    return tr


def _epoch(pipe, b, state=None):
    state = pipe.init() if state is None else state
    return pipe.run_epoch(state, pipe.default_key, b.values, b.strata,
                          b.counts)


def _profiled_epoch(pipe, b, path=None):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        out = _epoch(pipe, b)
    if path is not None:
        prof.export_chrome_trace(str(path))
    return out


def test_profiled_epoch_records_the_span_tree(tracer):
    pipe, b = _pipeline(), _ingest()
    _profiled_epoch(pipe, b)
    assert tracer.well_formed()
    ev = sorted(tracer.events, key=lambda e: e.t0)
    root, kids = ev[0], ev[1:]
    assert root.name == "run_epoch" and root.parent is None
    assert root.meta == {"ticks": TICKS} and root.epoch_id == root.id
    assert [e.name for e in kids] == CHILDREN
    assert all(e.parent == root.id and e.epoch_id == root.id
               and e.depth == 1 for e in kids)
    assert [e.meta["t"] for e in kids if e.name == "tick"] == [1, 2, 3]
    assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
    assert root.t0 <= kids[0].t0 and kids[-1].t1 <= root.t1
    nbytes = b.values.nbytes + b.strata.nbytes + b.counts.nbytes
    assert kids[0].meta == {"bytes": nbytes}
    assert tracer.counters["ingest_bytes"] == nbytes
    # the export carries each span's id, its parent and the epoch's id
    chrome = {e["id"]: e for e in tracer.chrome_trace()["traceEvents"]}
    assert chrome[root.id]["args"] == {"ticks": TICKS, "depth": 0,
                                       "epoch_id": root.id}
    for e in kids:
        assert chrome[e.id]["args"]["parent"] == root.id
        assert chrome[e.id]["args"]["epoch_id"] == root.id
        assert chrome[e.id]["ts"] == e.t0 / 1e3
    # a second epoch opens an epoch of its own
    _profiled_epoch(pipe, b)
    assert len({e.epoch_id for e in tracer.events}) == 2
    # device tensors are not copied: they count no bytes
    tracer.enabled = True
    pipe.run_epoch(pipe.init(), pipe.default_key,
                   *(torch.as_tensor(x) for x in
                     (b.values, b.strata.astype(np.int32),
                      b.counts.astype(np.int32))))
    assert tracer.events[-1].meta == {"ticks": TICKS}
    copy = [e for e in tracer.events if e.name == "ingest_copy"][-1]
    assert copy.meta == {"bytes": 0}


def test_default_tracer_without_profiler_records_nothing(tracer,
                                                         monkeypatch):
    def forbidden(name):
        raise AssertionError(f"record_function({name!r}) opened")

    opens = TT.record_function
    monkeypatch.setattr(TT, "record_function", forbidden)
    pipe, b = _pipeline(), _ingest()
    _epoch(pipe, b)
    assert not tracer.events and not tracer.calls and not tracer.counters
    assert TT.get_tracer() is tracer and not tracer.enabled
    with tracer.on(False):
        _epoch(pipe, b)
    assert not tracer.events
    monkeypatch.setattr(TT, "record_function", opens)
    with tracer.on():
        _epoch(pipe, b)
    assert not tracer.enabled
    assert [e.name for e in tracer.events][-1] == "run_epoch"


def test_tracing_changes_no_answer_and_no_state_bit(tracer):
    pipe, b = _pipeline(), _ingest(seed=3)
    runs = [_epoch(pipe, b), _profiled_epoch(pipe, b)]
    with tracer.on():
        runs.append(_epoch(pipe, b))
    assert len(tracer.events) == 2 * (1 + len(CHILDREN))
    (s0, w0), *rest = runs
    for s, w in rest:
        for name, a, c in zip(w0._fields, w0, w):
            if a is not None:
                assert torch.equal(a, c), name
        flat0 = torch.utils._pytree.tree_leaves((s0.tree, s0.tick))
        flat = torch.utils._pytree.tree_leaves((s.tree, s.tick))
        assert len(flat0) == len(flat)
        for a, c in zip(flat0, flat):
            assert torch.equal(a, c)


def test_ring_buffer_shares_the_profilers_clock(tracer, tmp_path):
    """On the profiler's clock (a Chrome export's ``ts`` after its
    ``baseTimeNanoseconds``) every program span's range holds the span's
    ring-buffer interval, and every operation inside the range lies in
    that interval, each to within 50 µs: one clock. The ranges' own edges
    sit outside the intervals by the profiler's work on entering and
    leaving a range, which grows with the operations recorded before it
    (4-66 µs here), so they are not compared with each other."""
    tol = 50_000
    pipe, b = _pipeline(), _ingest()
    _epoch(pipe, b)                          # first-call costs off the run
    path = tmp_path / "trace.json"
    _profiled_epoch(pipe, b, path)
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])

    def ns(ev):
        t0 = round(float(ev["ts"]) * 1e3) + base
        return t0, t0 + round(float(ev["dur"]) * 1e3)

    done = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    ann = sorted((ns(e) + (e["name"],) for e in done
                  if e.get("cat") == "user_annotation"))
    ops = [ns(e) for e in done if e.get("cat") == "cpu_op"]
    spans = sorted(tracer.events, key=lambda e: e.t0)
    assert [a[2] for a in ann] == [e.name for e in spans]
    for (a0, a1, _), sp in zip(ann, spans):
        assert a0 - tol <= sp.t0 and sp.t1 <= a1 + tol, sp.name
        inside = [(o0, o1) for o0, o1 in ops if a0 <= o0 < a1]
        assert inside, sp.name
        for o0, o1 in inside:
            assert sp.t0 - tol <= o0 and o1 <= sp.t1 + tol, sp.name
