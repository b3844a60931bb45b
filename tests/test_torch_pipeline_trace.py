"""The spans ``CompiledPipeline.run_epoch`` records, on the CPU.

Under ``torch.profiler`` one epoch leaves the tree ``run_epoch`` →
``ingest_copy``, ``tick_read``, ``priorities``, ``tick`` × T, each
``tick`` → ``level_tick`` a non-root level, in the default tracer's ring
buffer, on the profiler's own clock up to one constant; with the default
tracer and no profiler it records nothing and opens no
``record_function``; and tracing changes no answer and no state bit, at
4 strata and at the taxi deployment's 263. On the card (``cuda``
marker) ``level_tick``'s meta carries the kernel's regime as
``csrc/fused_level_tick.cu`` exports it.
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
# A tick's level_tick spans: (nodes, slots) of levels 0 and 1 at capacity
# 256 and fraction 0.1 (level 1 holds two children's 25 items, at least 64).
LEVELS = [(4, 256), (2, 64)]
TAXI_ZONES = 263


def _pipeline(num_strata=4, allocation="fair", device="cpu"):
    spec = api.PipelineSpec(
        topology=api.TopologySpec(fanin=(4, 2, 1), capacity=256,
                                  num_strata=num_strata),
        sampler=api.SamplerSpec(mode="whs", backend="pallas_fused",
                                allocation=allocation, fraction=0.1),
        telemetry=api.TelemetrySpec(enabled=True), seed=5)
    return api.compile(spec, device=device)


def _ingest(seed=0, num_strata=4):
    if num_strata == 4:
        specs = S.paper_gaussian(rates=(20,) * 4)
    else:   # zone r's share of 80 items a source, Zipf (s = 1)
        specs = [S.SubstreamSpec("gaussian", (10.0 + r, 2.0), 80.0 / r)
                 for r in range(1, num_strata + 1)]
    sources = [S.StreamSource(specs, seed=seed + i) for i in range(8)]
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
    root, kids = ev[0], [e for e in ev[1:] if e.depth == 1]
    assert root.name == "run_epoch" and root.parent is None
    assert root.meta == {"ticks": TICKS} and root.epoch_id == root.id
    assert [e.name for e in kids] == CHILDREN
    assert [e.name for e in ev if e.depth == 2] == ["level_tick"] * (
        len(LEVELS) * TICKS)
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


def _bitwise_same(a, b):
    (s0, w0), (s1, w1) = a, b
    for name, x, y in zip(w0._fields, w0, w1):
        if x is not None:
            assert torch.equal(x, y), name
    flat0 = torch.utils._pytree.tree_leaves((s0.tree, s0.tick))
    flat1 = torch.utils._pytree.tree_leaves((s1.tree, s1.tick))
    assert len(flat0) == len(flat1)
    for x, y in zip(flat0, flat1):
        assert torch.equal(x, y)


def test_tracing_changes_no_answer_and_no_state_bit(tracer):
    pipe, b = _pipeline(), _ingest(seed=3)
    runs = [_epoch(pipe, b), _profiled_epoch(pipe, b)]
    with tracer.on():
        runs.append(_epoch(pipe, b))
    assert len(tracer.events) == 2 * (1 + len(CHILDREN)
                                      + len(LEVELS) * TICKS)
    for run in runs[1:]:
        _bitwise_same(runs[0], run)


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


def _level_ticks_by_tick(tracer):
    """Each ``tick`` span's ``level_tick`` children, in order."""
    ticks = {e.id: e for e in tracer.events if e.name == "tick"}
    levels = sorted((e for e in tracer.events if e.name == "level_tick"),
                    key=lambda e: e.t0)
    assert all(e.parent in ticks and e.depth == ticks[e.parent].depth + 1
               and e.epoch_id == ticks[e.parent].epoch_id
               and ticks[e.parent].t0 <= e.t0 and e.t1 <= ticks[e.parent].t1
               for e in levels)
    return [[e for e in levels if e.parent == t]
            for t in sorted(ticks, key=lambda i: ticks[i].t0)]


@pytest.mark.parametrize("num_strata", [4, TAXI_ZONES])
@pytest.mark.parametrize("allocation", ["fair", "neyman"])
def test_level_tick_nests_in_tick_and_off_records_nothing(
        tracer, num_strata, allocation):
    """One ``level_tick`` a non-root level inside each ``tick``, its meta
    the level's shape (the plain version on the CPU has no kernel regime);
    off, nothing is recorded and every answer and state bit is the
    traced run's."""
    pipe, b = _pipeline(num_strata, allocation), _ingest(7, num_strata)
    off = _epoch(pipe, b)
    assert not tracer.events
    with tracer.on():
        on = _epoch(pipe, b)
    _bitwise_same(off, on)
    assert tracer.well_formed()
    per_tick = _level_ticks_by_tick(tracer)
    assert len(per_tick) == TICKS
    for levels in per_tick:
        assert [e.meta for e in levels] == [
            {"nodes": n, "slots": cap, "strata": num_strata}
            for n, cap in LEVELS]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("num_strata,allocation,want", [
    (4, "neyman", (8, 4, 1)), (4, "fair", (8, 4, 0)),
    (TAXI_ZONES, "neyman", (6, 6, 3)), (TAXI_ZONES, "fair", (6, 6, 0))])
def test_level_tick_meta_is_the_kernels_regime(tracer, cuda_device,
                                               num_strata, allocation, want):
    """On the card each ``level_tick`` also carries the launch's regime,
    read from the functions the kernel's source exports: at 4 strata
    8-bit digits (4 passes) and one moments window; at 263, 6-bit digits
    (6 passes) and three windows of 128 strata (neyman only)."""
    from repro_torch.kernels.fused_level_tick import ops as ft_ops

    lib = ft_ops._lib()
    exported = {
        "digit_bits": lib.fused_level_tick_digit_bits(num_strata),
        "radix_passes": lib.fused_level_tick_radix_passes(num_strata),
        "moment_windows": lib.fused_level_tick_moment_windows(
            num_strata, ft_ops._POLICIES[allocation])}
    assert tuple(exported.values()) == want
    pipe = _pipeline(num_strata, allocation, device=cuda_device)
    b = _ingest(7, num_strata)
    off = _epoch(pipe, b)
    with tracer.on():
        on = _epoch(pipe, b)
    _bitwise_same(off, on)
    for levels in _level_ticks_by_tick(tracer):
        assert [e.meta for e in levels] == [
            {"nodes": n, "slots": cap, "strata": num_strata, **exported}
            for n, cap in LEVELS]
