"""The port's analytics driver against the reference's, on the CPU.

``run_pipeline`` of both packages on the same stream mix and seed: the
SUM, its 2σ bound, the exact sum, forwarded and ingested counts,
dispatches and windows must be equal (bitwise as floats), over every
``--dist``, every engine and the ``topk`` and ``pallas`` backends. The
neyman and SRS runs, the error-budget controller, the tenant arbiter,
the adaptive strata and telemetry are in
``tests/test_torch_analytics_control.py``. Rates are cut to 40 items per
sub-stream and tick so that level 0 holds 1,024 items and the
reference's ``pallas`` kernels, which run in interpret mode here, stay
quick.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import stream as JS  # noqa: E402
from repro.launch import analytics as JA  # noqa: E402
from repro_torch.data import stream as S  # noqa: E402
from repro_torch.launch import analytics as TA  # noqa: E402

EXACT = ("approx_sum", "bound_2sigma", "exact_sum", "accuracy_loss",
         "within_2sigma", "items_ingested", "items_forwarded",
         "bandwidth_fraction", "dispatches", "windows", "fraction", "mode",
         "engine", "sampler_backend", "latency_window_ticks")


def _specs(mod, dist):
    return {
        "gaussian": lambda: mod.paper_gaussian(rates=(40,) * 4),
        "poisson": lambda: mod.paper_poisson(rates=(40,) * 4),
        "poisson-skewed": lambda: mod.paper_poisson(
            rates=tuple(160 * s for s in mod.SKEW_SHARES), skewed=True),
        "taxi": lambda: mod.taxi_like(rate=16),
        "pollution": lambda: mod.pollution_like(rate=40),
    }[dist]()


def _both(dist, **kw):
    ref = JA.run_pipeline(_specs(JS, dist), **kw)
    port = TA.run_pipeline(_specs(S, dist), device="cpu", **kw)
    return port, ref


def _same(port, ref, keys=EXACT):
    for k in keys:
        assert port[k] == ref[k], (k, port[k], ref[k])


def test_every_stream_kind_draws_the_reference_stream():
    for dist in ("gaussian", "poisson", "poisson-skewed", "taxi",
                 "pollution"):
        js = JS.StreamSource(_specs(JS, dist), seed=3)
        ts = S.StreamSource(_specs(S, dist), seed=3)
        for _ in range(3):
            for a, b in zip(ts.tick(), js.tick()):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


@pytest.mark.parametrize("dist,engine,backend", [
    ("gaussian", "level", "pallas"), ("gaussian", "scan", "topk"),
    ("poisson", "loop", "pallas"), ("poisson-skewed", "scan", "pallas"),
    ("taxi", "level", "topk"), ("pollution", "loop", "topk"),
    ("pollution", "scan", "pallas")])
def test_run_pipeline_matches_reference(dist, engine, backend):
    kw = dict(fraction=0.1, ticks=3, seed=2, engine=engine,
              sampler_backend=backend, warmup_ticks=1)
    port, ref = _both(dist, **kw)
    _same(port, ref)
    assert port["dispatches"] == (1 if engine == "scan" else
                                  3 * (3 if engine == "level" else 7))
