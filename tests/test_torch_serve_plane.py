"""The port's streaming serve plane (``repro_torch.serve``) against the
reference's (``repro.serve``) on the CPU.

The same inputs go through both packages: the bounded queues under each
backpressure policy (the degrade policy's sheds included), the double
buffer, the publisher's widening rules for every slot kind, and the
executor with an injected ``FakeClock`` and deterministic sources
(``ConstantSource``, ``SyntheticSource``, ``LateShardSource``, overflow
under ``drop_oldest`` and ``degrade``). Published windows are compared
bitwise: the pipelines are bitwise alike on the CPU, but for the
sketches' bounds, which sum the sketch's weights in another order and
are held to ``TOTAL_RTOL`` (1e-5). ``stats()`` must be equal but for
``overlap_fraction``, a wall-clock measurement. The reference's pipeline
is waited for after each epoch (``_Synced``): its executor otherwise races
its own staging buffers. Then the port's own laws
(the on-time run is bitwise the synchronous epochs, ``stop()`` drains,
restart), the ``repro_serve_*`` metric families, and the serve CLI's
``--serve-loop`` and ``--inject-straggler`` lines, numbers aside. No
assertion reads the wall clock or depends on how many ticks fit in
``--duration``.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.launch import serve as JSV  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.query.registry import QueryRegistry as JQ  # noqa: E402
import repro_torch as tapi  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.query import QueryRegistry as TQ  # noqa: E402

TOTAL_RTOL = 1e-5
SKETCH_KINDS = ("quantile", "windowed_quantile", "heavy_hitters",
                "decayed_heavy_hitters")
BOTH = ((japi, jserve, JQ), (tapi, tserve, TQ))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def _small_registry(Q):
    return Q().register_count("n").register_sum("s").register_mean("m")


def _recency_registry(Q):
    """Every slot kind the widening rules tell apart."""
    return (_small_registry(Q)
            .register_histogram("h", 0.0, 40.0, 8)
            .register_quantile("q", (0.5, 0.9), capacity=64)
            .register_windowed_quantile("wq", (0.5,), capacity=32, window=3)
            .register_heavy_hitters("hh", k=4, width=128)
            .register_decayed_heavy_hitters("dhh", k=4, width=128,
                                            decay=0.8))


def _spec(api, Q, registry=_small_registry, fraction=1.0,
          telemetry=False):
    return api.PipelineSpec(
        topology=api.TopologySpec(fanin=(2, 1), capacity=256, num_strata=2),
        sampler=api.SamplerSpec(mode="whs", backend="topk",
                                fraction=fraction),
        tenants=(registry(Q).as_tenant("t"),),
        telemetry=api.TelemetrySpec(enabled=telemetry), seed=0)


class _Synced:
    """The reference's pipeline with each ``run_epoch`` waited for before
    it returns. The reference executor zeroes a staged host buffer at the
    swap after its epoch was dispatched, while JAX's CPU client may still
    be reading it (``jnp.asarray`` can alias an aligned numpy buffer, and
    dispatch is asynchronous): its last windows then read zeros in about
    half the runs (ROADMAP Queue 3). Waiting closes that race and changes
    no bit of what is computed."""

    def __init__(self, pipe):
        self._pipe = pipe

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def run_epoch(self, *args, **kwargs):
        out = self._pipe.run_epoch(*args, **kwargs)
        jax.block_until_ready(out)
        return out


def _compile(api, spec):
    return api.compile(spec, device="cpu") if api is tapi else \
        _Synced(api.compile(spec))


def _constant(serve):
    return [serve.ConstantSource(0, rate=6, value=2.0, stratum=0),
            serve.ConstantSource(1, rate=6, value=3.0, stratum=1)]


def _late(serve):
    return [serve.ConstantSource(0, rate=8, value=2.0),
            serve.LateShardSource(serve.ConstantSource(1, rate=8, value=2.0),
                                  4, 6)]


def _synthetic(serve):
    def src(shard):
        return serve.SyntheticSource(shard, specs=[
            _substream(serve, (5.0 + 10 * c, 2.0 + c), 3 + 2 * c)
            for c in range(2)], seed=10 + shard)
    return [src(0), serve.LateShardSource(src(1), 5, 7)]


def _substream(serve, params, rate):
    from repro.data import stream as JS
    from repro_torch.data import stream as TS

    mod = TS if serve is tserve else JS
    return mod.SubstreamSpec("gaussian", params, rate)


def _overflow(serve):
    return [serve.ConstantSource(0, rate=48, value=2.0),
            serve.ConstantSource(1, rate=40, value=1.0, stratum=1)]


# name → (sources, registry, fraction, executor options, ticks)
SCENARIOS = {
    "constant": (_constant, _small_registry, 1.0, {}, 8),
    "late_shard": (_late, _small_registry, 1.0, {}, 12),
    "synthetic_late": (_synthetic, _recency_registry, 0.5, {}, 14),
    "drop_oldest": (_overflow, _small_registry, 1.0,
                    dict(policy="drop_oldest", queue_capacity=32,
                         max_records=24), 9),
    "degrade": (_overflow, _recency_registry, 0.5,
                dict(policy="degrade", queue_capacity=32, seed=3), 9),
}


def _run(api, serve, Q, name, telemetry=False):
    sources, registry, fraction, opts, ticks = SCENARIOS[name]
    pipe = _compile(api, _spec(api, Q, registry, fraction, telemetry))
    clock = FakeClock()
    kw = dict(epoch_ticks=4, width=64, queue_capacity=256)
    kw.update(opts)
    ex = serve.StreamingExecutor(clock=clock, **kw)
    ex.start(pipe, sources(serve), warmup=False)
    for _ in range(ticks):
        clock.t += 1.0
        ex.pump()
    return pipe, ex, ex.stop()


def _sketch_cols(pipe):
    return [c for o, w, kind in pipe.query_layout().values()
            if kind in SKETCH_KINDS for c in range(o, o + w)]


def _same_windows(jp, jwins, twins):
    assert len(jwins) == len(twins) > 0
    cols = _sketch_cols(jp)
    for j, t in zip(jwins, twins):
        for f in ("tick", "partial", "alpha", "publish_time",
                  "first_arrival", "latency", "sum", "sum_var", "mean",
                  "mean_var", "n_sampled"):
            assert getattr(j, f) == getattr(t, f), (f, j.tick)
        _bits(np.asarray(j.histogram), np.asarray(t.histogram), "histogram")
        _bits(np.asarray(j.answers), np.asarray(t.answers), "answers")
        jb, tb = np.asarray(j.bounds), np.asarray(t.bounds)
        exact = np.setdiff1d(np.arange(jb.shape[-1]), cols)
        _bits(jb[exact], tb[exact], "bounds")
        np.testing.assert_allclose(tb[cols], jb[cols], rtol=TOTAL_RTOL)
        _bits(np.asarray(j.raw["answers"]), np.asarray(t.raw["answers"]),
              "raw answers")


# ---------------------------------------------------------------- queues --
@pytest.mark.parametrize("policy", ["block", "drop_oldest", "degrade"])
def test_queue_is_the_reference(policy):
    jq = jserve.BoundedShardQueue(capacity=16, policy=policy, seed=3)
    tq = tserve.BoundedShardQueue(capacity=16, policy=policy, seed=3)
    rng = np.random.default_rng(0)
    for step in range(60):
        n = int(rng.integers(0, 12))
        v = rng.normal(size=n)
        s = rng.integers(0, 4, n).astype(np.int32)
        assert tq.put(v, s, float(step)) == jq.put(v, s, float(step))
        k = int(rng.integers(0, 6))
        for a, b in zip(tq.get_many(k), jq.get_many(k)):
            _bits(a, b)
        assert tq.stats() == jq.stats()
        assert tq.depth == jq.depth and tq.accounting_ok
    if policy != "block":
        assert tq.items_dropped > 0
    else:
        assert tq.deferred > 0


def test_queue_rejects_bad_policy_and_capacity():
    with pytest.raises(ValueError, match="policy"):
        tserve.BoundedShardQueue(capacity=4, policy="shrug")
    with pytest.raises(ValueError, match="capacity"):
        tserve.BoundedShardQueue(capacity=0)
    assert tserve.POLICIES == jserve.POLICIES


# --------------------------------------------------------------- staging --
def test_double_buffer_is_the_reference():
    rng = np.random.default_rng(1)
    bufs = [m.DoubleBuffer(epoch_ticks=3, n_nodes=2, width=8)
            for m in (jserve, tserve)]
    for epoch in range(3):
        for t in range(3):
            for node in (0, 1, 0, 1):   # two batches a row: truncation
                n = int(rng.integers(0, 7))
                v = rng.normal(size=n).astype(np.float32)
                s = rng.integers(0, 3, n).astype(np.int32)
                arrival = float(rng.random())
                got = [b.stage(t, node, v, s, arrival=arrival) for b in bufs]
                assert got[0] == got[1]
                assert bufs[0].first_arrival(t) == bufs[1].first_arrival(t)
        j, p = (b.swap() for b in bufs)
        assert j._fields == p._fields
        for f in j._fields:
            _bits(getattr(j, f), getattr(p, f), f)
    assert bufs[1].truncated_total == bufs[0].truncated_total > 0
    assert bufs[1].staged_total == bufs[0].staged_total
    # the newly active set is zeroed on swap
    assert bufs[1].first_arrival(0) == np.inf
    assert bufs[1].swap().counts.sum() == 0


# ------------------------------------------------------------- publisher --
class _StubPipeline:
    plan = object()

    def query_layout(self):
        return {"c": (0, 1, "count"), "s": (1, 1, "sum"),
                "h": (2, 3, "histogram"), "m": (5, 1, "mean"),
                "q": (6, 2, "quantile"), "wq": (8, 1, "windowed_quantile"),
                "hh": (9, 4, "heavy_hitters"),
                "dhh": (13, 4, "decayed_heavy_hitters")}


@pytest.mark.parametrize("alpha", [0.5, 0.37, 1.0])
def test_publisher_widening_is_the_reference(alpha):
    rng = np.random.default_rng(2)
    row = dict(tick=3, sum=10.5, sum_var=4.25, mean=5.0, mean_var=1.5,
               n_sampled=7, histogram=rng.random(8).astype(np.float32),
               answers=rng.normal(10, 3, 17).astype(np.float32),
               bounds=rng.random(17).astype(np.float32))
    wins = [m.WindowPublisher(_StubPipeline()).publish(
        row, alpha=alpha, partial=alpha < 1.0, publish_time=9.0,
        first_arrival=7.5) for m in (jserve, tserve)]
    j, t = wins
    assert j._fields == t._fields
    for f in j._fields:
        a, b = getattr(j, f), getattr(t, f)
        if isinstance(a, np.ndarray):
            _bits(a, b, f)
        else:
            assert a == b, f
    if alpha < 1.0:
        assert (np.asarray(t.bounds) >= row["bounds"]).all()
    else:
        assert t.answers is row["answers"]


# ------------------------------------------------------------- executor --
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_executor_publishes_the_reference_windows(name):
    jp, jex, jst = _run(japi, jserve, JQ, name)
    tp, tex, tst = _run(tapi, tserve, TQ, name)
    _same_windows(jp, jex.published, tex.published)
    jst.pop("overlap_fraction")
    tst.pop("overlap_fraction")
    assert tst == jst
    assert tst["queue_depth"] == [0, 0]
    assert tex.monitor.late_shards_total == jex.monitor.late_shards_total
    assert (tex.monitor.widened_windows_total
            == jex.monitor.widened_windows_total)
    if name in ("late_shard", "synthetic_late", "degrade"):
        assert tst["windows_partial"] > 0
    if name in ("drop_oldest", "degrade"):
        assert tst["queue_items_dropped"] > 0


def test_on_time_run_is_bitwise_equal_to_synchronous_epochs():
    """The reference's law on the port: complete windows pass the
    pipeline's arrays through untouched, so the executor adds nothing
    to ``run_epoch`` with its key schedule on the same ingest."""
    pipe, ex, _ = _run(tapi, tserve, TQ, "constant")
    assert all(not w.partial and w.alpha == 1.0 for w in ex.published)
    values = np.zeros((4, 2, 64), np.float32)
    strata = np.zeros((4, 2, 64), np.int32)
    counts = np.full((4, 2), 6, np.int32)
    values[:, 0, :6] = 2.0
    values[:, 1, :6] = 3.0
    strata[:, 1, :6] = 1
    state = pipe.init()
    rows = []
    for epoch in range(2):
        key = prng.fold_in(pipe.default_key, epoch)
        state, wa = pipe.run_epoch(state, key, values, strata, counts)
        rows.extend(pipe.rows(wa))
    assert len(rows) == len(ex.published) == 8
    for row, win in zip(rows, ex.published):
        assert row["tick"] == win.tick
        _bits(row["answers"], win.answers)
        _bits(row["bounds"], win.bounds)
        assert row["sum"] == win.sum and row["mean"] == win.mean
        _bits(row["histogram"], win.histogram)


def test_late_shard_widens_then_folds_and_conserves():
    pipe, ex, summary = _run(tapi, tserve, TQ, "late_shard")

    def n(vec):
        return float(pipe.answer(vec, "n")[0])

    partials = [w for w in ex.published if w.partial]
    assert [w.tick for w in partials] == [5, 6]
    for w in partials:
        assert w.alpha == 0.5
        assert n(w.raw["answers"]) == 8.0 and n(w.answers) == 16.0
        np.testing.assert_allclose(np.asarray(w.bounds, np.float64),
                                   np.asarray(w.raw["bounds"]) / w.alpha,
                                   rtol=1e-6)
    by_tick = {w.tick: w for w in ex.published}
    assert n(by_tick[7].raw["answers"]) == 32.0 and not by_tick[7].partial
    assert sum(n(w.raw["answers"]) for w in ex.published) == \
        summary["queue_items_in"]


def test_stop_drains_queues_clean_and_restarts():
    pipe = tapi.compile(_spec(tapi, TQ), device="cpu")
    clock = FakeClock()
    ex = tserve.StreamingExecutor(clock=clock, epoch_ticks=4, width=64,
                                  queue_capacity=256, max_records=4)
    ex.start(pipe, [tserve.ConstantSource(0, rate=8),
                    tserve.ConstantSource(1, rate=8)], warmup=False)
    with pytest.raises(RuntimeError, match="already started"):
        ex.start(pipe, [])
    for _ in range(6):
        clock.t += 1.0
        ex.pump()
    assert any(q.depth > 0 for q in ex._queues)
    summary = ex.stop()
    assert summary["queue_depth"] == [0, 0]
    assert summary["queue_items_in"] == summary["queue_items_out"]
    assert all(q.accounting_ok for q in ex._queues)
    total = sum(float(pipe.answer(w.raw["answers"], "n")[0])
                for w in ex.published)
    assert total == summary["queue_items_in"]
    with pytest.raises(RuntimeError, match="not started"):
        ex.stop()
    ex.start(pipe, [tserve.ConstantSource(0, rate=4),
                    tserve.ConstantSource(1, rate=4)])
    for _ in range(4):
        clock.t += 1.0
        ex.pump()
    assert ex.stop()["windows_published"] == 4


def test_executor_runs_on_the_pipeline_device():
    """No fallback: the executor's state lives where the pipeline runs."""
    pipe, ex, _ = _run(tapi, tserve, TQ, "constant")
    assert ex.state.tick.device == pipe.device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.compile(_spec(tapi, TQ))


# --------------------------------------------------------------- metrics --
def test_serve_metric_families_are_the_reference():
    texts = []
    for (api, serve, Q), metrics in zip(BOTH, (jmetrics, tmetrics)):
        pipe, ex, _ = _run(api, serve, Q, "late_shard", telemetry=True)
        texts.append(metrics.metrics_text(pipeline=pipe, state=ex.state,
                                          straggler=ex.monitor,
                                          executor=ex))
    j, t = (jmetrics.parse_prometheus_text(x) for x in texts)
    serve_fams = sorted(f for f in j if f.startswith("repro_serve_")
                        or f.startswith("repro_straggler_"))
    assert len(serve_fams) == 15   # 11 serve, 2 telemetry, 2 monitor
    for fam in serve_fams:
        assert t[fam]["type"] == j[fam]["type"], fam
        if fam != "repro_serve_ingest_overlap_fraction":
            assert t[fam]["samples"] == j[fam]["samples"], fam
    assert t["repro_serve_windows_partial_total"]["samples"][()] == 2.0
    assert t["repro_straggler_late_shards_total"]["samples"][()] == 2.0
    helps = [{ln for ln in x.splitlines() if ln.startswith("# HELP")
              and ln.split()[2] in serve_fams} for x in texts]
    assert len(helps[1]) == 15 and helps[1] == helps[0]


# ------------------------------------------------------------------- CLI --
def _shape(text: str) -> list[str]:
    """The printed lines with every number blanked."""
    return [re.sub(r"\d+(\.\d+)?(e[+-]\d+)?", "#", line)
            for line in text.strip().splitlines()]


LOOP = ["--serve-loop", "--duration", "0.3", "--tick-interval", "0.01"]


@pytest.mark.parametrize("extra", [[], ["--inject-straggler"],
                                   ["--backpressure", "degrade",
                                    "--queue-capacity", "8"]])
def test_serve_loop_prints_the_reference_lines(capsys, tmp_path, extra):
    dump = str(tmp_path / "metrics.txt")
    args = LOOP + extra + ["--metrics-dump", dump]
    summary = TSV.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    JSV.main(args)
    want = capsys.readouterr().out
    assert _shape(got) == _shape(want)
    assert summary["queue_depth"] == [0, 0]
    assert summary["windows_published"] >= 1
    fams = tmetrics.parse_prometheus_text(open(dump).read())
    assert "repro_serve_windows_published_total" in fams
    if "--inject-straggler" in extra:
        assert "straggler injected" in got.splitlines()[0]
