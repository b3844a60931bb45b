"""The port's pipeline against the reference's, end to end on the CPU.

One ``PipelineSpec`` (the reference's, loaded into the port with
``from_dict``), one seeded ingest, both packages' ``compile`` →
``init`` → ``run_epoch``: window answers, forwarded counts and every
state buffer are compared; sums, variances and histograms within
``ANSWER_RTOL`` (they come out bitwise on the CPU too). Also: state
carried from the reference to the port, the device rule, and that the
port never loads JAX or the reference package.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as J  # noqa: E402
from repro.api.spec import StrataSpec as JStrata  # noqa: E402
from repro.api.pipeline import PipelineState as JState  # noqa: E402
from repro.core.window import TreeState as JTree  # noqa: E402
from repro.obs.telemetry import EpochTelemetry as JTel  # noqa: E402
import repro_torch as P  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import stream as S  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ANSWER_RTOL = 1e-6
LEVEL_FIELDS = ("values", "strata", "fill", "dropped", "w_in", "c_in",
                "wc_acc", "c_acc", "seen")


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def _spec(backend="pallas_fused", mode="whs", allocation="fair",
          interval_ticks=None, num_keys=0):
    return J.PipelineSpec(
        topology=J.TopologySpec(fanin=(4, 2, 1), capacity=256,
                                num_strata=4, interval_ticks=interval_ticks),
        sampler=J.SamplerSpec(mode=mode, backend=backend,
                              allocation=allocation, fraction=0.1),
        telemetry=J.TelemetrySpec(enabled=True), seed=5,
        strata=JStrata(num_keys=num_keys))


def _ingest(ticks, seed=0, rate=20):
    sources = [S.StreamSource(S.paper_gaussian(rates=(rate,) * 4),
                              seed=seed + i) for i in range(8)]
    return S.batch_ingest(sources, ticks, 4, 256)


def _compare(jwa, twa, js, ts, exact_sums=True):
    for f in ("tick", "ok", "n_sampled", "n_forwarded"):
        _bits(getattr(twa, f).numpy(), np.asarray(getattr(jwa, f)), f)
    for f in ("sum", "sum_var", "mean", "mean_var", "histogram"):
        np.testing.assert_allclose(getattr(twa, f).numpy(),
                                   np.asarray(getattr(jwa, f)),
                                   rtol=ANSWER_RTOL if exact_sums else 1e-5,
                                   err_msg=f)
    for f in LEVEL_FIELDS:
        for l, (t, j) in enumerate(zip(getattr(ts.tree, f),
                                       getattr(js.tree, f))):
            _bits(t.numpy(), np.asarray(j), f"{f}[{l}]")
    _bits(ts.tick.numpy(), np.asarray(js.tick), "tick")
    jt, tt = js.tree.telemetry, ts.tree.telemetry
    for f in ("items_in", "items_kept", "flushes", "saturation_hits",
              "stratum_in", "stratum_kept", "windows"):
        _bits(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), f)
    np.testing.assert_allclose(tt.root_sum.numpy(), np.asarray(jt.root_sum),
                               rtol=ANSWER_RTOL if exact_sums else 1e-5)


def _run_both(jspec, ticks=8, seed=0):
    b = _ingest(ticks, seed)
    jp = J.compile(jspec)
    js, jwa = jp.run_epoch(jp.init(), jp.default_key, b.values, b.strata,
                           b.counts)
    tp = P.compile(P.PipelineSpec.from_dict(jspec.to_dict()), device="cpu")
    ts, twa = tp.run_epoch(tp.init(), tp.default_key, b.values, b.strata,
                           b.counts)
    return jp, js, jwa, tp, ts, twa


@pytest.mark.parametrize("backend", ["pallas_fused", "topk", "argsort"])
def test_run_epoch_matches_reference(backend):
    jp, js, jwa, tp, ts, twa = _run_both(_spec(backend))
    _compare(jwa, twa, js, ts)
    assert tp.rows(twa)[0].keys() == jp.rows(jwa)[0].keys()
    assert [r["n_sampled"] for r in tp.rows(twa)] == \
        [r["n_sampled"] for r in jp.rows(jwa)]
    tsnap, jsnap = tp.telemetry_snapshot(ts), jp.telemetry_snapshot(js)
    assert tsnap["windows"] == jsnap["windows"] == 8
    np.testing.assert_allclose(tsnap["bound_2sigma"], jsnap["bound_2sigma"],
                               rtol=ANSWER_RTOL)


@pytest.mark.parametrize("allocation", ["proportional", "neyman"])
def test_run_epoch_matches_reference_other_allocations(allocation):
    _, js, jwa, _, ts, twa = _run_both(_spec("pallas_fused",
                                             allocation=allocation))
    _compare(jwa, twa, js, ts)


def test_srs_epoch_matches_reference():
    _, js, jwa, _, ts, twa = _run_both(_spec(mode="srs"))
    # SRS sums run over whole sample buffers, in another order than
    # the reference's compiled reductions.
    _compare(jwa, twa, js, ts, exact_sums=False)


def test_intervals_and_routing_table_match_reference():
    """Levels flushing every 2 ticks (appends into non-empty buffers,
    skipped ticks) and the static key→stratum table."""
    _, js, jwa, _, ts, twa = _run_both(
        _spec("topk", interval_ticks=(1, 2, 2), num_keys=6), ticks=8)
    _compare(jwa, twa, js, ts)


def test_state_carried_across_with_convert():
    """Epoch 1 on the reference, its state into the port, epoch 2 on
    both; and the port's state back into the reference."""
    jspec = _spec("pallas_fused")
    b1, b2 = _ingest(4, seed=0), _ingest(4, seed=100)
    jp = J.compile(jspec)
    js, _ = jp.run_epoch(jp.init(), jp.default_key, b1.values, b1.strata,
                         b1.counts)
    host = jax.tree.map(np.asarray, js)
    tp = P.compile(P.PipelineSpec.from_dict(jspec.to_dict()), device="cpu")
    ts = convert.state_from_numpy(host)
    ts, twa = tp.run_epoch(ts, tp.default_key, b2.values, b2.strata,
                           b2.counts)
    js, jwa = jp.run_epoch(js, jp.default_key, b2.values, b2.strata,
                           b2.counts)
    _compare(jwa, twa, js, ts)
    back = convert.state_to_numpy(ts)
    tree = back["tree"]
    js2 = JState(tree=JTree(
        **{f: tuple(jnp.asarray(a) for a in tree[f]) for f in LEVEL_FIELDS},
        qstate=(), telemetry=JTel(**{k: jnp.asarray(v) for k, v in
                                     tree["telemetry"].items()}),
        route=()), tick=jnp.asarray(back["tick"]))
    jax.tree.map(lambda a, b: _bits(np.asarray(a), np.asarray(b)), js2, js)
    again = convert.state_from_numpy(back)
    for f in LEVEL_FIELDS:
        for a, b in zip(getattr(again.tree, f), getattr(ts.tree, f)):
            assert torch.equal(a, b)


def test_step_is_an_epoch_of_one_tick():
    spec = P.PipelineSpec.from_dict(_spec("topk").to_dict())
    tp = P.compile(spec, device="cpu")
    b = _ingest(2)
    s1, w1 = tp.run_epoch(tp.init(), tp.default_key, b.values, b.strata,
                          b.counts)
    s2 = tp.init()
    for t in range(2):
        s2, w = tp.step(s2, tp.default_key, b.values[t], b.strata[t],
                        b.counts[t])
        assert float(w.sum[0]) == float(w1.sum[t])
    for f in LEVEL_FIELDS:
        for a, c in zip(getattr(s1.tree, f), getattr(s2.tree, f)):
            assert torch.equal(a, c)


def test_batch_ingest_matches_reference():
    from repro.data import stream as JS

    mk = lambda mod: [mod.StreamSource(mod.paper_gaussian(rates=(30,) * 4),
                                       seed=i) for i in range(8)]
    want = JS.batch_ingest(mk(JS), 3, 4, 100)   # width cuts some ticks
    got = S.batch_ingest(mk(S), 3, 4, 100)
    for f in ("values", "strata", "counts", "offered"):
        _bits(getattr(got, f), getattr(want, f), f)
    assert (got.exact_sum, got.exact_count) == (want.exact_sum,
                                                want.exact_count)
    # Every kind of the reference is drawn (tests/test_torch_analytics.py
    # holds them against the reference); an unknown kind raises.
    with pytest.raises(ValueError, match="unknown sub-stream kind"):
        S.StreamSource([S.SubstreamSpec("uniform", (10.0,), 5)]).tick()


def test_spec_round_trip_and_unported_parts():
    jspec = _spec()
    spec = P.PipelineSpec.from_dict(jspec.to_dict())
    assert spec.to_dict() == jspec.to_dict()
    r, jr = P.resolve(spec), J.resolve(jspec)
    assert (r.capacities, r.sample_sizes, r.p_level) == (
        jr.capacities, jr.sample_sizes, jr.p_level)
    tenanted = dict(jspec.to_dict(), tenants=[{"name": "t", "queries": []}])
    with pytest.raises(P.SpecError, match="registers no queries"):
        P.PipelineSpec.from_dict(tenanted)
    # The ``pallas`` backend is ported (ROADMAP Queue 2 item 6): compile
    # accepts it; an unknown backend is refused by the spec.
    assert P.compile(P.PipelineSpec(sampler=P.SamplerSpec(backend="pallas")),
                     device="cpu").spec.sampler.backend == "pallas"
    with pytest.raises(P.SpecError, match="sampler.backend"):
        P.SamplerSpec(backend="nope")
    with pytest.raises(P.SpecError, match="one entry per level"):
        P.compile(spec, device="cpu").clamp_budgets([1.0])


def test_compile_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.compile(P.PipelineSpec())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.compile(P.PipelineSpec(), device="cuda")
    assert P.compile(P.PipelineSpec(), device="cpu").device.type == "cpu"


def _imports(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def test_port_never_imports_jax_or_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert REPO / "src" / "repro_torch" / "query" / "compiler.py" in files
    assert REPO / "src" / "repro_torch" / "launch" / "analytics.py" in files
    for mod in ("launch/serve.py", "models/model.py", "models/layers.py",
                "kernels/flash_attention/ops.py", "optim/train_step.py",
                "configs/registry.py", "configs/smollm_135m.py"):
        assert REPO / "src" / "repro_torch" / mod in files, mod
    files += [REPO / "chip_smoke.py", REPO / "examples" / "quickstart_torch.py",
              REPO / "examples" / "taxi_analytics_torch.py"]
    tools = sorted((REPO / "tools").glob("*.py"))
    for tool in ("flash_planted_faults.py", "flash_rounding_check.py",
                 "fused_tick_phases.py", "kernel_ab.py", "fadd_chain.py"):
        assert REPO / "tools" / tool in tools, tool
    files += tools
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.kernels.fused_level_tick.ops, "
            "repro_torch.kernels.stratified_stats.ops, "
            "repro_torch.kernels.sketch_update.ops, "
            "repro_torch.kernels.sample_mask.ops, "
            "repro_torch.kernels.segment_sum.ops, "
            "repro_torch.query.compiler, repro_torch.query.sketches, "
            "repro_torch.launch.analytics, repro_torch.strata, "
            "repro_torch.runtime.budget, repro_torch.obs.metrics, "
            "repro_torch.obs.trace, repro_torch.launch.serve, "
            "repro_torch.models.model, repro_torch.optim.train_step, "
            "repro_torch.kernels.flash_attention.ops\n"
            "from repro_torch.configs import registry\n"
            "[registry.get_config(n) for n in registry.ARCH_NAMES]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
