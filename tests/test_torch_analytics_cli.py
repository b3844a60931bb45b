"""The port's analytics CLI against the reference's, and the host-side
units ``run_pipeline`` runs (budget controller, strata manager, span tracer,
metrics text) against the reference's pure functions, on the CPU. The
CLI runs the pollution mix (level-0 capacity 2,304), where the
reference's ``pallas`` kernels in interpret mode stay quick.
"""
import io
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import analytics as JA  # noqa: E402
from repro.obs import metrics as JM  # noqa: E402
from repro.runtime import budget as JB  # noqa: E402
from repro.strata import manager as JSM  # noqa: E402
from repro_torch.launch import analytics as TA  # noqa: E402
from repro_torch.obs import metrics as TM  # noqa: E402
from repro_torch.obs import trace as TT  # noqa: E402
from repro_torch.runtime import budget as TB  # noqa: E402
from repro_torch.strata import manager as TSM  # noqa: E402

def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


def _sum_line(lines):
    (line,) = [ln for ln in lines if ln.strip().startswith("SUM ≈")]
    return line


@pytest.mark.parametrize("engine", ["level", "loop", "scan"])
def test_cli_prints_the_reference_sum_line(engine):
    argv = ["--dist", "pollution", "--ticks", "2", "--engine", engine,
            "--backend", "pallas"]
    want = _stdout(JA.main, argv)
    got = _stdout(TA.main, argv + ["--device", "cpu"])
    assert _sum_line(got) == _sum_line(want)
    assert got[0] == want[0]
    dispatches = {"level": 6, "loop": 14, "scan": 1}[engine]
    assert f"{dispatches} step dispatches) on cpu" in got[4]


def test_cli_json_report_and_refusals(tmp_path, monkeypatch):
    out = tmp_path / "r.json"
    TA.main(["--dist", "taxi", "--ticks", "2", "--engine", "scan",
             "--telemetry", "--device", "cpu", "--json", str(out),
             "--trace", str(tmp_path / "trace.json")])
    r = json.loads(out.read_text())
    assert r["windows"] == 2 and r["telemetry"]["windows"] == 2
    assert "repro_windows_total 2" in r["metrics"]
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert {"epoch_dispatch", "block_until_ready", "ingest"} <= {
        e["name"] for e in trace["traceEvents"]}
    # the mesh refuses what it cannot run: the adaptive strata (a scan
    # engine state), and a multi-rank mesh outside the rank processes
    with pytest.raises(ValueError, match="adaptive-strata"):
        TA.main(["--mesh", "2", "--adaptive-strata", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="spawn_ranks"):
        TA.run_spmd_pipeline(TA.stream_specs("taxi"), ticks=1, n_devices=2,
                             device="cpu", backend="gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.main(["--ticks", "1"])


# ------------------------------------------------------------- units --
def test_budget_controller_matches_reference():
    rng = np.random.default_rng(0)
    errs = rng.uniform(0.0, 0.05, 12)
    for cls_kw in (dict(target_rel_error=0.01),
                   dict(target_rel_error=0.02, target_latency_s=0.5)):
        jc = JB.BudgetController(JB.BudgetConfig(8, 4000, **cls_kw), 300)
        tc = TB.BudgetController(TB.BudgetConfig(8, 4000, **cls_kw), 300)
        for i, e in enumerate(errs):
            lat = 0.3 + 0.1 * i
            assert tc.update(rel_error=e, latency_s=lat) == jc.update(
                rel_error=e, latency_s=lat)
        assert tc.size == jc.size
    for ins, kept in (([1000, 100, 50], [100, 50, 10]), ([0, 0], [0, 0]),
                      ([10, 10], [10, 10])):
        assert TB.level_error_shares(ins, kept) == JB.level_error_shares(
            ins, kept)
    ja = JB.WorstTenantArbiter(JB.BudgetConfig(8, 4000, None, 0.01), 200)
    ta = TB.WorstTenantArbiter(TB.BudgetConfig(8, 4000, None, 0.01), 200)
    for per in ({"a": 0.02, "b": 0.005}, {"a": float("nan"), "b": 0.03},
                {"a": 0.001, "b": 0.002}):
        assert ta.update(per) == ja.update(per)
        assert ta.update_levels(per, [0.7, 0.2, 0.1]) == ja.update_levels(
            per, [0.7, 0.2, 0.1])
        assert ta.last_tenant == ja.last_tenant


def test_stratum_manager_matches_reference():
    rng = np.random.default_rng(1)
    route = np.array([0, 0, 1, 1, 2, 3, 3, 3], np.int32)
    jm = JSM.StratumManager(route, 6, split_occupancy=1.5,
                            merge_occupancy=0.1)
    tm = TSM.StratumManager(route, 6, split_occupancy=1.5,
                            merge_occupancy=0.1)
    for _ in range(4):
        kc = rng.zipf(1.6, 8).astype(np.float64)
        km = kc * rng.uniform(1, 100, 8)
        jm.observe(kc, km)
        tm.observe(kc, km)
        jo, to = jm.maybe_adapt(), tm.maybe_adapt()
        assert [vars(o) for o in to] == [vars(o) for o in jo]
        np.testing.assert_array_equal(tm.route, jm.route)
    assert tm.ops_log and len(tm.ops_log) == len(jm.ops_log)
    with pytest.raises(ValueError, match="route entries"):
        TSM.StratumManager([0, 9], 4)


def test_remap_tree_state_matches_reference():
    import jax.numpy as jnp

    from repro.core.window import TreeState as JTree
    from repro_torch.core.window import TreeState as TTree

    rng = np.random.default_rng(2)
    fanin, caps, x = [2, 1], [16, 16], 4
    leaves = {
        "w_in": [rng.uniform(0.5, 3, (n, x)).astype(np.float32)
                 for n in fanin],
        "c_in": [rng.integers(0, 50, (n, x)).astype(np.float32)
                 for n in fanin],
        "wc_acc": [rng.uniform(0, 90, (n, x)).astype(np.float32)
                   for n in fanin],
        "c_acc": [rng.integers(0, 30, (n, x)).astype(np.float32)
                  for n in fanin],
        "seen": [rng.random((n, x)) < 0.5 for n in fanin]}
    js = JTree.create(fanin, caps, x, route=jnp.arange(6, dtype=jnp.int32))
    ts = TTree.create(fanin, caps, x, route=torch.arange(6,
                                                         dtype=torch.int32))
    js = js._replace(**{k: tuple(jnp.asarray(a) for a in v)
                        for k, v in leaves.items()})
    ts = ts._replace(**{k: tuple(torch.from_numpy(a.copy()) for a in v)
                        for k, v in leaves.items()})
    ops = [JSM.StratumOp("merge", src=3, dst=1, keys=(5,), share=1.0),
           JSM.StratumOp("split", src=0, dst=3, keys=(1,), share=0.3)]
    tops = [TSM.StratumOp(**vars(o)) for o in ops]
    route = np.array([0, 3, 1, 1, 2, 1], np.int32)
    want = JSM.remap_tree_state(js, ops, route)
    got = TSM.remap_tree_state(ts, tops, route)
    np.testing.assert_array_equal(got.route.numpy(), np.asarray(want.route))
    for k in leaves:
        for a, b in zip(getattr(got, k), getattr(want, k)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.numpy().dtype == np.asarray(b).dtype


def test_span_tracer_and_metrics_text():
    tr = TT.SpanTracer(capacity=8)
    with tr.span("epoch_dispatch", t0=1):
        with tr.span("inner"):
            tr.count("widgets", 3)
    with tr.span("block_until_ready"):
        pass
    assert tr.well_formed()
    ev = tr.chrome_trace()["traceEvents"]
    assert [e["name"] for e in ev] == ["inner", "epoch_dispatch",
                                       "block_until_ready"]
    assert ev[1]["args"] == {"t0": 1, "depth": 0}
    assert tr.calls["epoch_dispatch"] == 1
    off = TT.SpanTracer(enabled=False)
    with off.span("x"):
        pass
    assert not off.events
    text = TM.metrics_text(tracer=tr, extra={"repro_ticks": 4})
    parsed = TM.parse_prometheus_text(text)
    assert parsed == JM.parse_prometheus_text(text)
    assert parsed["repro_widgets_total"]["samples"][()] == 3.0
    assert parsed["repro_ticks"]["samples"][()] == 4.0
    reg = TM.MetricsRegistry()
    reg.gauge("g", float("inf"), "h", tenant='a"b')
    assert reg.to_text() == '# HELP g h\n# TYPE g gauge\ng{tenant="a\\"b"} +Inf\n'
    with pytest.raises(ValueError):
        TM.parse_prometheus_text("")
