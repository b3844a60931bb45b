"""The port's analytics driver against the reference's, on the CPU.

``run_pipeline`` of both packages on the same stream mix and seed: the
SUM, its 2σ bound, the exact sum, forwarded and ingested counts,
dispatches and windows must be equal (bitwise as floats), over every
``--dist``, every engine and the ``topk`` and ``pallas`` backends. The
error-budget controller's trajectory, the adaptive strata's operations
and route table, and the telemetry snapshot with its Prometheus lines
must be the reference's too. Rates are cut to 40 items per sub-stream
and tick so that level 0 holds 1,024 items and the reference's
``pallas`` kernels, which run in interpret mode here, stay quick.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api.spec import StrataSpec as JStrata  # noqa: E402
from repro.data import stream as JS  # noqa: E402
from repro.launch import analytics as JA  # noqa: E402
from repro.obs import metrics as JM  # noqa: E402
from repro.query.registry import QueryRegistry as JQ  # noqa: E402
from repro_torch.api.spec import StrataSpec as TStrata  # noqa: E402
from repro_torch.data import stream as S  # noqa: E402
from repro_torch.launch import analytics as TA  # noqa: E402
from repro_torch.obs import metrics as TM  # noqa: E402
from repro_torch.query.registry import QueryRegistry as TQ  # noqa: E402

TOTAL_RTOL = 1e-5
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


def test_neyman_and_srs_runs_match_reference():
    port, ref = _both("gaussian", fraction=0.1, ticks=3, seed=4,
                      engine="level", sampler_backend="pallas",
                      allocation="neyman")
    _same(port, ref)
    port, ref = _both("taxi", fraction=0.2, ticks=3, seed=4, engine="level",
                      mode="srs")
    # SRS sums run over the whole sample buffer, in another order than
    # the reference's compiled reduction.
    _same(port, ref, keys=("exact_sum", "items_ingested", "items_forwarded",
                           "dispatches", "windows"))
    np.testing.assert_allclose(port["approx_sum"], ref["approx_sum"],
                               rtol=1e-5)


@pytest.mark.parametrize("engine", ["level", "scan"])
def test_controller_trajectory_matches_reference(engine):
    kw = dict(fraction=0.05, ticks=4, seed=1, engine=engine,
              sampler_backend="topk", target_rel_error=0.004,
              epoch_ticks=2)
    port, ref = _both("gaussian", **kw)
    assert port["controller"] == ref["controller"]
    assert len(port["controller"]) >= 2
    assert port["final_sample_sizes"] == ref["final_sample_sizes"]
    _same(port, ref)


def test_two_tenant_arbiter_matches_reference():
    kw = dict(fraction=0.05, ticks=4, seed=1, engine="scan", epoch_ticks=2,
              target_rel_error=0.01)
    qs = lambda Q: [Q().register_sum().register_mean().as_tenant("a"),  # noqa
                    Q().register_mean("m").register_count().as_tenant("b")]
    ref = JA.run_pipeline(_specs(JS, "gaussian"), queries=qs(JQ), **kw)
    port = TA.run_pipeline(_specs(S, "gaussian"), queries=qs(TQ),
                           device="cpu", **kw)
    assert port["controller"] == ref["controller"]
    assert port["controller"][0]["tenant"] in ("a", "b")
    _same(port, ref)
    for a, b in zip(port["windows_answers"], ref["windows_answers"]):
        np.testing.assert_array_equal(a, b)


def test_adaptive_strata_match_reference():
    """The skewed Poisson mix starves two strata: the manager merges
    them; ops, route table and answers follow the reference's."""
    kw = dict(fraction=0.1, ticks=6, seed=3, engine="scan", epoch_ticks=2,
              sampler_backend="topk")
    ref = JA.run_pipeline(_specs(JS, "poisson-skewed"),
                          strata=JStrata(num_keys=4, adaptive=True), **kw)
    port = TA.run_pipeline(_specs(S, "poisson-skewed"),
                           strata=TStrata(num_keys=4, adaptive=True),
                           device="cpu", **kw)
    assert port["strata_ops"] == ref["strata_ops"]
    assert any(op["kind"] == "merge" for op in port["strata_ops"])
    assert port["strata_route"] == ref["strata_route"]
    _same(port, ref)


def test_telemetry_snapshot_and_metrics_match_reference():
    kw = dict(fraction=0.1, ticks=4, seed=5, engine="scan",
              sampler_backend="pallas", telemetry=True,
              queries=None)
    reg = lambda Q: (Q().register_sum().register_mean()  # noqa: E731
                     .register_quantile("q", (0.5,), capacity=64))
    ref = JA.run_pipeline(_specs(JS, "gaussian"),
                          **dict(kw, queries=reg(JQ)))
    port = TA.run_pipeline(_specs(S, "gaussian"), device="cpu",
                           **dict(kw, queries=reg(TQ)))
    _same(port, ref)
    pt, rt = port["telemetry"], ref["telemetry"]
    for k in ("levels", "strata", "windows", "sum_estimate", "bound_2sigma",
              "rel_bound_2sigma", "merge_bytes", "late_shards",
              "widened_windows"):
        assert pt[k] == rt[k], k
    np.testing.assert_allclose(pt["slot_rel_bound_mean"],
                               rt["slot_rel_bound_mean"], rtol=TOTAL_RTOL)
    assert pt["tenant_rel_bounds"] == rt["tenant_rel_bounds"]
    # The telemetry-derived families are the reference's, line for line;
    # cache, span and trace counters belong to each process.
    fams = ("repro_items_in_total", "repro_items_kept_total",
            "repro_level_flushes_total", "repro_saturation_hits_total",
            "repro_effective_fraction", "repro_stratum_effective_fraction",
            "repro_windows_total", "repro_realized_bound_2sigma",
            "repro_realized_rel_bound_2sigma", "repro_tenant_rel_bound",
            "repro_spmd_summary_bytes_total",
            "repro_straggler_late_shards_total",
            "repro_straggler_widened_windows_total")
    mp = TM.parse_prometheus_text(port["metrics"])
    mr = JM.parse_prometheus_text(ref["metrics"])
    for fam in fams:
        assert mp[fam] == mr[fam], fam
    for fam in ("repro_program_cache_misses_total",
                "repro_plan_cache_builds_total",
                "repro_span_seconds_total"):
        assert fam in mp
    assert "repro_windows_total 4\n" in port["metrics"]
