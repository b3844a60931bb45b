"""The serve plane on the card: the executor's epochs through the CUDA
kernels.

Every test needs a CUDA device: each carries the ``cuda`` marker and
skips without one. The module imports neither JAX nor the reference:

    python -m pytest -m cuda tests/test_torch_cuda_serve.py

With a fake clock and constant or synthetic sources, the executor on the
card publishes windows bitwise those of ``run_epoch`` on the card with
the executor's key schedule (the on-time law), and, with a late shard,
those of the same run on the CPU but for the sketches' bounds (a sum
over the sketch's weights in another order, ``SKETCH_BOUND_RTOL``). Its
epochs launch ``fused_level_tick``, ``fused_select``,
``stratified_stats``, ``cms_update``, ``quantile_compact`` and
``segment_sum``. A checkpoint saved on the card restores into a fresh
compile and resumes bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as P  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import stream as S  # noqa: E402
from repro_torch.query import QueryRegistry as Q  # noqa: E402

SKETCH_BOUND_RTOL = 1e-5
SKETCH_KINDS = ("quantile", "windowed_quantile", "heavy_hitters",
                "decayed_heavy_hitters")
PATH_KERNELS = ("fused_level_tick", "fused_select", "stratified_stats",
                "cms_update", "quantile_compact", "segment_sum")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _spec():
    reg = (Q().register_count("n").register_sum("s").register_mean("m")
           .register_quantile("q", (0.5, 0.99), capacity=128)
           .register_decayed_heavy_hitters("hot", k=4, width=256,
                                           decay=0.8))
    return P.PipelineSpec(
        topology=P.TopologySpec(fanin=(4, 2, 1), capacity=2048,
                                num_strata=4),
        sampler=P.SamplerSpec(mode="whs", backend="pallas_fused",
                              fraction=0.1),
        tenants=(reg.as_tenant("dash"),),
        telemetry=P.TelemetrySpec(enabled=True), seed=0)


def _sources(late: bool):
    srcs = [serve.SyntheticSource(i, specs=S.paper_gaussian(
        rates=(250,) * 4), seed=i) for i in range(4)]
    if late:
        srcs[3] = serve.LateShardSource(srcs[3], 4, 8)
    return srcs


def _run(device, late, ticks=12):
    pipe = P.compile(_spec(), device=device)
    clock = FakeClock()
    ex = serve.StreamingExecutor(epoch_ticks=4, width=2048,
                                 queue_capacity=8192, clock=clock)
    ex.start(pipe, _sources(late), warmup=False)
    for _ in range(ticks):
        clock.t += 1.0
        ex.pump()
    return pipe, ex, ex.stop()


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def test_on_time_run_is_bitwise_the_synchronous_epochs(cuda_device):
    from repro_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    pipe, ex, summary = _run(cuda_device, late=False)
    launches = dict(LAUNCHES)
    for name in PATH_KERNELS:
        assert launches[name] > 0, (name, launches)
    assert summary["windows_partial"] == 0
    # the same staged ingest: each tick drains every queue (no truncation)
    assert summary["truncated_items"] == summary["queue_deferred"] == 0
    srcs = [S.StreamSource(S.paper_gaussian(rates=(250,) * 4), seed=i)
            for i in range(4)]
    state = pipe.init()
    rows = []
    for epoch in range(3):
        b = S.batch_ingest(srcs, 4, 4, 2048)
        key = prng.fold_in(pipe.default_key, epoch)
        state, wa = pipe.run_epoch(state, key, b.values, b.strata, b.counts)
        rows.extend(pipe.rows(wa))
    assert len(rows) == len(ex.published) == 12
    for row, win in zip(rows, ex.published):
        assert row["tick"] == win.tick and not win.partial
        _bits(row["answers"], win.answers)
        _bits(row["bounds"], win.bounds)
        assert row["sum"] == win.sum and row["mean"] == win.mean
        _bits(row["histogram"], win.histogram)


def test_late_shard_run_is_the_cpu_run(cuda_device):
    pipe, ex, summary = _run(cuda_device, late=True)
    _, cex, csummary = _run("cpu", late=True)
    assert summary["windows_partial"] > 0
    summary.pop("overlap_fraction")
    csummary.pop("overlap_fraction")
    assert summary == csummary and summary["queue_depth"] == [0] * 4
    cols = [c for o, w, kind in pipe.query_layout().values()
            if kind in SKETCH_KINDS for c in range(o, o + w)]
    assert len(ex.published) == len(cex.published)
    for k, c in zip(ex.published, cex.published):
        assert (k.tick, k.partial, k.alpha) == (c.tick, c.partial, c.alpha)
        assert (k.sum, k.sum_var, k.mean, k.mean_var) == (
            c.sum, c.sum_var, c.mean, c.mean_var)
        _bits(k.histogram, c.histogram)
        _bits(k.answers, c.answers)
        exact = np.setdiff1d(np.arange(c.bounds.shape[-1]), cols)
        _bits(k.bounds[exact], c.bounds[exact])
        np.testing.assert_allclose(k.bounds[cols], c.bounds[cols],
                                   rtol=SKETCH_BOUND_RTOL)


def test_checkpoint_on_the_card_resumes_bitwise(cuda_device, tmp_path):
    srcs = [S.StreamSource(S.paper_gaussian(rates=(250,) * 4), seed=i)
            for i in range(4)]
    e1, e2 = (S.batch_ingest(srcs, 4, 4, 2048) for _ in range(2))
    pipe = P.compile(_spec(), device=cuda_device)
    st, _ = pipe.run_epoch(pipe.init(), pipe.default_key, e1.values,
                           e1.strata, e1.counts)
    P.api.save_state(tmp_path, 1, st, pipeline=pipe)
    _, want = pipe.run_epoch(st, pipe.default_key, e2.values, e2.strata,
                             e2.counts)
    fresh = P.compile(_spec(), device=cuda_device)
    restored, _ = P.api.restore_state(tmp_path, fresh)
    assert restored.tick.device == cuda_device
    _, got = fresh.run_epoch(restored, fresh.default_key, e2.values,
                             e2.strata, e2.counts)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
