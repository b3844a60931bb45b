"""The port's straggler accounting against the reference's, on the CPU.

``runtime.straggler`` (``calibrate_weights``, ``DeadlineTracker``) and
``obs.telemetry`` (``fold_stragglers``, ``StragglerMonitor``) take the
same seeded inputs in both packages. The calibrated weights, the
present-masks and the running totals are compared exactly; the folded
telemetry leaves of a pipeline state, read back through
``convert.state_to_numpy``, bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.obs import telemetry as JT  # noqa: E402
from repro.runtime import straggler as JS  # noqa: E402
import repro_torch as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.obs import telemetry as TT  # noqa: E402
from repro_torch.runtime import straggler as TS  # noqa: E402


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_calibrate_weights_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    for dtype in (np.float32, np.float64):
        w = np.abs(rng.normal(1, 0.5, 33)).astype(dtype)
        present = rng.random(33) < 0.6
        _bits(TS.calibrate_weights(w, present),
              JS.calibrate_weights(w, present))
        # nothing arrived: all zero, as the reference
        none = np.zeros(33, bool)
        _bits(TS.calibrate_weights(w, none), JS.calibrate_weights(w, none))


@pytest.mark.parametrize("factor,quorum", [(2.0, 0.5), (1.2, 0.9)])
def test_deadline_tracker_is_the_reference(factor, quorum):
    rng = np.random.default_rng(7)
    t = TS.DeadlineTracker(5, TS.StragglerConfig(factor, quorum))
    j = JS.DeadlineTracker(5, JS.StragglerConfig(factor, quorum))
    for _ in range(80):   # past the 64-row rolling window
        lat = rng.exponential(1.0, 5) * (1 + 5 * (rng.random(5) < 0.2))
        _bits(t.observe(lat), j.observe(lat))
    _bits(t.lat, j.lat)


def _pipelines(telemetry):
    def spec(api):
        return api.PipelineSpec(
            topology=api.TopologySpec(fanin=(2, 1), capacity=64,
                                      num_strata=2),
            sampler=api.SamplerSpec(mode="whs", backend="topk",
                                    fraction=0.5),
            telemetry=api.TelemetrySpec(enabled=telemetry), seed=1)
    return tapi.compile(spec(tapi), device="cpu"), japi.compile(spec(japi))


@pytest.mark.parametrize("telemetry", [True, False])
def test_straggler_monitor_folds_as_the_reference(telemetry):
    tp, jp = _pipelines(telemetry)
    tst, jst = tp.init(), jp.init()
    tm, jm = TT.StragglerMonitor(3), JT.StragglerMonitor(3)
    rng = np.random.default_rng(3)
    for window in range(12):
        lat = rng.exponential(1.0, 3)
        lat[window % 3] *= 10.0 if window % 4 == 0 else 1.0
        _bits(tm.observe(lat), jm.observe(lat))
        w = np.abs(rng.normal(1, 0.3, 4))
        p = rng.random(4) < 0.7
        _bits(tm.calibrate(w, p), jm.calibrate(w, p))
        if window % 5 == 4:
            tst, jst = tm.fold_into(tst), jm.fold_into(jst)
    tst, jst = tm.fold_into(tst), jm.fold_into(jst)
    assert tm.late_shards_total == jm.late_shards_total > 0
    assert tm.widened_windows_total == jm.widened_windows_total > 0
    got = convert.state_to_numpy(tst)["tree"]["telemetry"]
    if not telemetry:
        assert got == () and TT.snapshot(tst) is None
        return
    want = {f: np.asarray(v) for f, v in
            zip(JT.EpochTelemetry._fields, jst.tree.telemetry)}
    assert set(got) == set(want)
    for f in want:
        _bits(got[f], want[f], f)
    snap = TT.snapshot(tst)
    assert snap["late_shards"] == jm.late_shards_total
    assert snap["widened_windows"] == jm.widened_windows_total
    # no deltas since the last fold: the state comes back unchanged
    assert tm.fold_into(tst) is tst


def test_fold_stragglers_is_a_state_edit_on_the_states_device():
    tp, _ = _pipelines(True)
    st = tp.init()
    st2 = TT.fold_stragglers(st, 3, 1)
    tel = st2.tree.telemetry
    assert tel.late_shards.dtype == torch.int32 and int(tel.late_shards) == 3
    assert int(tel.widened_windows) == 1
    assert tel.late_shards.device == tp.device
    assert TT.fold_stragglers(st, 0, 0) is st
