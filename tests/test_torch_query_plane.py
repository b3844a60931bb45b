"""The port's standing-query plane against the reference, on the CPU.

The same window samples (made from a seed with numpy) go through the
reference's jitted ``CompiledQueryPlan``/``SlotPlanCore`` and the port's,
and the same two-tenant spec through both pipelines. Answers, CLT bounds
and every sketch state leaf compare bitwise. The sketch queries' bounds
(quantile and windowed-quantile rank bounds, the heavy-hitter ``ε·W``)
and the telemetry's ``slot_rel_bound_sum`` built from them compare within
``TOTAL_RTOL``: they are divided by, or are, an f32 sum over the sketch's
slots that the reference's compiled reduction adds in an order of its
own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as J  # noqa: E402
from repro.core.types import IntervalBatch as JBatch  # noqa: E402
from repro.core.types import SampleResult as JRes  # noqa: E402
from repro.core.types import StratumMeta as JMeta  # noqa: E402
from repro.query import compiler as JC  # noqa: E402
from repro.query.registry import QueryRegistry as JReg  # noqa: E402
from repro.query.registry import QuerySpec as JSpec  # noqa: E402
import repro_torch as P  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.types import IntervalBatch as TBatch  # noqa: E402
from repro_torch.core.types import SampleResult as TRes  # noqa: E402
from repro_torch.core.types import StratumMeta as TMeta  # noqa: E402
from repro_torch.data import stream as S  # noqa: E402
from repro_torch.query import compiler as TC  # noqa: E402
from repro_torch.query.registry import QueryRegistry as TReg  # noqa: E402
from repro_torch.query.registry import QuerySpec as TSpec  # noqa: E402

TOTAL_RTOL = 1e-5
SKETCH_KINDS = ("quantile", "windowed_quantile")
HH_KINDS = ("heavy_hitters", "decayed_heavy_hitters")


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(np.asarray(a)), np.ascontiguousarray(
        np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape,
                                                       b.shape, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def _k8(reg):
    """``benchmarks/fig8_accuracy.py`` ``k8_registry()``."""
    return (reg().register_sum().register_count().register_mean()
            .register_histogram("hist_coarse", 0.0, 120_000.0, 16)
            .register_histogram("hist_fine", 0.0, 2_000.0, 32)
            .register_quantile("quantiles", (0.5, 0.9, 0.99), capacity=256)
            .register_quantile("median", (0.5,), capacity=256)
            .register_heavy_hitters("heavy", k=8, width=1024, depth=4))


def _dashboard(reg):
    """``launch/serve.py`` ``serve_registry(window=4)``."""
    return (reg().register_count("requests")
            .register_sum("latency_total_ms")
            .register_mean("latency_mean_ms")
            .register_quantile("latency_q_ms", qs=(0.5, 0.99), capacity=256)
            .register_windowed_quantile("latency_q_recent_ms",
                                        qs=(0.5, 0.99), capacity=128,
                                        window=4)
            .register_decayed_heavy_hitters("hot_latency_keys", k=4,
                                            width=256, decay=0.8))


def _small(reg):
    """All eight kinds at small capacities, a histogram with lo ≠ 0."""
    return (reg().register_sum().register_count().register_mean()
            .register_histogram("h", -3.3, 177.7, 16)
            .register_quantile("q", (0.5, 0.9, 0.99), capacity=32)
            .register_heavy_hitters("hh", k=4, width=64, depth=3)
            .register_windowed_quantile("wq", (0.5, 0.99), capacity=16,
                                        window=3)
            .register_decayed_heavy_hitters("dhh", k=3, width=32,
                                            decay=0.8))


def _tolerant_columns(layout) -> np.ndarray:
    """Bound columns held to ``TOTAL_RTOL``: sketch rank bounds and the
    heavy-hitter estimate bounds."""
    cols = []
    for o, w, kind in layout.values():
        if kind in SKETCH_KINDS:
            cols.extend(range(o, o + w))
        elif kind in HH_KINDS:
            cols.extend(range(o + w // 2, o + w))
    return np.asarray(cols, np.int64)


def _compare_bounds(got, want, layout):
    got, want = np.asarray(got), np.asarray(want)
    tol = _tolerant_columns(layout)
    exact = np.setdiff1d(np.arange(want.shape[-1]), tol)
    _bits(got[..., exact], want[..., exact], "bounds")
    np.testing.assert_allclose(got[..., tol], want[..., tol],
                               rtol=TOTAL_RTOL, err_msg="sketch bounds")


def _compare_qstate(t, j):
    """Port state (tensors) against the reference's, leaf by leaf."""
    if isinstance(j, tuple) and not hasattr(j, "_fields"):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _compare_qstate(a, b)
    elif hasattr(j, "_fields"):
        assert tuple(t._fields) == tuple(j._fields)
        for f in j._fields:
            _bits(getattr(t, f).numpy(), getattr(j, f), f)
    else:
        _bits(t.numpy(), j)


def _window(rng, m, x):
    v = np.round(rng.normal(80, 20, m), 1).astype(np.float32)
    s = rng.integers(0, x, m).astype(np.int32)
    valid = rng.random(m) < 0.9
    sel = valid & (rng.random(m) < 0.5)
    w = rng.uniform(1, 4, x).astype(np.float32)
    c = rng.integers(10, 90, x).astype(np.float32)
    jb = JBatch(v, s, valid, JMeta(w, c))
    jr = JRes(sel, JMeta(w, c), c, c, c)
    t = {k: torch.from_numpy(a) for k, a in
         dict(v=v, s=s, valid=valid, sel=sel, w=w, c=c).items()}
    tb = TBatch(t["v"], t["s"], t["valid"], TMeta(t["w"], t["c"]))
    tr = TRes(t["sel"], TMeta(t["w"], t["c"]), t["c"], t["c"], t["c"])
    return jb, jr, tb, tr


def _tkey(key) -> torch.Tensor:
    return torch.tensor(np.asarray(key).astype(np.int64))


# ------------------------------------------------------------ one plan --
def test_compiled_plan_evaluate_matches_reference():
    x = 4
    jp = JC.CompiledQueryPlan(_small(JReg).specs, x)
    tp = TC.CompiledQueryPlan(_small(TReg).specs, x)
    assert tp.layout() == jp.layout() and tp.n_out == jp.n_out
    ev = jax.jit(jp.evaluate)
    js, ts = jp.init_state(), tp.init_state()
    rng = np.random.default_rng(1)
    for step in range(6):
        jb, jr, tb, tr = _window(rng, 300, x)
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        js, ja, jbd = ev(key, jb, jr, js)
        ts, ta, tbd = tp.evaluate(tp.draws(_tkey(key)), tb, tr, ts)
        _bits(ta.numpy(), ja, f"answers, window {step}")
        _compare_bounds(tbd.numpy(), jbd, jp.layout())
        _compare_qstate(ts, js)
    # the sketches compacted: the rank bounds are no longer 0
    assert float(ts[4].compactions) > 0 and float(ts[6].compactions[0]) > 0


@pytest.mark.parametrize("kinds", [("count",), ("mean",), ("sum", "count"),
                                   ("count", "mean"), ("mean", "sum",
                                                       "count")])
def test_count_and_mean_follow_the_reference_contraction(kinds):
    """``Σ Y_i·W_i`` is one FMA per stratum unless a count and a mean
    share it, when the reference's compiled program rounds the products
    first (30 windows: a 1-ulp difference shows within a few)."""
    jp = JC.CompiledQueryPlan(tuple(JSpec(k, k) for k in kinds), 4)
    tp = TC.CompiledQueryPlan(tuple(TSpec(k, k) for k in kinds), 4)
    ev = jax.jit(jp.evaluate)
    rng = np.random.default_rng(len(kinds))
    for step in range(30):
        jb, jr, tb, tr = _window(rng, 300, 4)
        _, ja, jbd = ev(jax.random.PRNGKey(0), jb, jr, jp.init_state())
        _, ta, tbd = tp.evaluate(None, tb, tr, tp.init_state())
        _bits(ta.numpy(), ja, f"answers, window {step}")
        _bits(tbd.numpy(), jbd, f"bounds, window {step}")


def test_stratum_stats_matches_reference():
    rng = np.random.default_rng(4)
    jb, _, tb, _ = _window(rng, 500, 5)
    want = jax.jit(JC.stratum_stats, static_argnums=1)(jb, 5)
    for a, b in zip(TC.stratum_stats(tb, 5), want):
        _bits(a.numpy(), b)


def test_slot_plan_core_with_two_groups_matches_reference():
    """Groups: ``a`` and ``c`` share a signature (two slots), ``b`` has
    its own; ``c``'s slot is then switched off (inactive slots freeze and
    answer zeros)."""
    x = 4
    other = lambda reg: (reg().register_mean("m")  # noqa: E731
                         .register_quantile("p", (0.25, 0.75), capacity=16))
    jplan = JC.build_slotted_plan(
        [("a", _small(JReg).specs), ("b", other(JReg).specs),
         ("c", _small(JReg).specs)], x)
    tplan = TC.build_slotted_plan(
        [("a", _small(TReg).specs), ("b", other(TReg).specs),
         ("c", _small(TReg).specs)], x)
    assert [n for _, n in tplan.core.groups] == [2, 1]
    assert tplan.layout() == jplan.layout()
    assert tplan.live_columns().tolist() == jplan.live_columns().tolist()
    ev = jax.jit(jplan.evaluate)
    js, ts = jplan.init_state(), tplan.init_state()
    rng = np.random.default_rng(9)
    for step in range(4):
        if step == 2:
            js = (js[0][0].at[1].set(False), js[0][1]), js[1]
            ts[0][0][1] = False
        jb, jr, tb, tr = _window(rng, 200, x)
        key = jax.random.fold_in(jax.random.PRNGKey(3), step)
        js, ja, jbd = ev(key, jb, jr, js)
        ts, ta, tbd = tplan.evaluate(tplan.draws(_tkey(key)), tb, tr, ts)
        _bits(ta.numpy(), ja, f"padded answers, window {step}")
        _compare_bounds(tbd.numpy(), jbd, _padded_layout(tplan))
        _compare_qstate(ts, js)
        _bits(tplan.compact(ta).numpy(), jplan.compact(ja))
    o, w = tplan.padded_slice("c")
    assert not ta[o:o + w].any()


# ------------------------------------------------------ MultiTenantPlan --
def _two_tenants(reg):
    return [("k8", _k8(reg).specs), ("dashboard", _dashboard(reg).specs)]


def test_multi_tenant_plan_matches_reference():
    """The testbed's ``k8`` + ``dashboard`` tenants at its root (2,200
    slots, 4 strata) over 6 windows: answers, CLT bounds and every
    sketch state leaf bitwise the reference's jitted plan, sketch bounds
    within ``TOTAL_RTOL``; the public vector bitwise the slot plan's,
    which replaced it."""
    x = 4
    jplan = JC.MultiTenantPlan(_two_tenants(JReg), x)
    tplan = TC.MultiTenantPlan(_two_tenants(TReg), x)
    slots = TC.build_slotted_plan(_two_tenants(TReg), x)
    assert tplan.layout() == jplan.layout() == slots.layout()
    assert (tplan.n_out, tplan.k) == (jplan.n_out, jplan.k)
    for t in ("k8", "dashboard"):
        assert tplan.tenant_slice(t) == jplan.tenant_slice(t)
    ev = jax.jit(jplan.evaluate)
    js, ts, ss = jplan.init_state(), tplan.init_state(), slots.init_state()
    rng = np.random.default_rng(12)
    for step in range(6):
        jb, jr, tb, tr = _window(rng, 2200, x)
        key = jax.random.fold_in(jax.random.PRNGKey(8), step)
        js, ja, jbd = ev(key, jb, jr, js)
        ts, ta, tbd = tplan.evaluate(tplan.draws(_tkey(key)), tb, tr, ts)
        _bits(ta.numpy(), ja, f"answers, window {step}")
        _compare_bounds(tbd.numpy(), jbd, jplan.layout())
        _compare_qstate(ts, js)
        ss, sa, sbd = slots.evaluate(slots.draws(_tkey(key)), tb, tr, ss)
        _bits(ta.numpy(), slots.compact(sa).numpy(), "slot plan answers")
        _bits(tbd.numpy(), slots.compact(sbd).numpy(), "slot plan bounds")
    with pytest.raises(KeyError):
        tplan.plan_for("nope")
    with pytest.raises(ValueError, match="duplicate tenant names"):
        TC.MultiTenantPlan([("a", _k8(TReg).specs)] * 2, x)


def test_multi_tenant_plan_tenants_are_single_plans():
    """Each tenant's block of the fused evaluation is bitwise a
    single-tenant plan of its registry on the same sample and root key:
    answers, bounds and state, locally and on a one-rank data mesh
    (``evaluate_spmd``)."""
    from repro_torch.launch.mesh import DataMesh

    x = 4
    tplan = TC.MultiTenantPlan(_two_tenants(TReg), x)
    singles = {t: TC.CompiledQueryPlan(sp, x) for t, sp in
               _two_tenants(TReg)}
    mesh = DataMesh(rank=0, size=1, device=torch.device("cpu"),
                    backend="gloo")
    state = {"local": tplan.init_state(), "spmd": tplan.init_state()}
    alone = {(t, m): p.init_state() for t, p in singles.items()
             for m in state}
    rng = np.random.default_rng(13)
    for step in range(4):
        _, _, tb, tr = _window(rng, 2200, x)
        key = _tkey(jax.random.fold_in(jax.random.PRNGKey(9), step))
        state["local"], ta, tbd = tplan.evaluate(
            tplan.draws(key), tb, tr, state["local"])
        state["spmd"], sa, sbd = tplan.evaluate_spmd(
            tplan.draws_spmd(key, 0), tb, tr, state["spmd"], mesh)
        for i, (t, p) in enumerate(singles.items()):
            alone[t, "local"], a, b = p.evaluate(p.draws(key), tb, tr,
                                                 alone[t, "local"])
            _bits(tplan.tenant_answers(ta, t), a.numpy(), t)
            _bits(tplan.tenant_answers(tbd, t), b.numpy(), t)
            _compare_qstate(state["local"][i], tuple(
                _tree_numpy(alone[t, "local"])))
            alone[t, "spmd"], a, b = p.evaluate_spmd(
                p.draws_spmd(key, 0), tb, tr, alone[t, "spmd"], mesh)
            _bits(tplan.tenant_answers(sa, t), a.numpy(), t)
            _bits(tplan.tenant_answers(sbd, t), b.numpy(), t)
            _compare_qstate(state["spmd"][i], tuple(
                _tree_numpy(alone[t, "spmd"])))


def _tree_numpy(tree):
    """A port state's tensor leaves as numpy, its tuples kept."""
    if torch.is_tensor(tree):
        return tree.numpy()
    out = [_tree_numpy(t) for t in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


@pytest.mark.parametrize("kind", ["slotted", "multi"])
def test_answer_and_tenant_answers_slice_like_the_reference(kind):
    """``answer`` and ``tenant_answers`` of both multi-tenant plans cut
    the reference's slots out of a flat vector, or a stack of them,
    given as a tensor or an array."""
    x = 4
    if kind == "slotted":
        jplan = JC.build_slotted_plan(_two_tenants(JReg), x)
        tplan = TC.build_slotted_plan(_two_tenants(TReg), x)
    else:
        jplan = JC.MultiTenantPlan(_two_tenants(JReg), x)
        tplan = TC.MultiTenantPlan(_two_tenants(TReg), x)
    vec = np.arange(3 * jplan.n_out, dtype=np.float32).reshape(3, -1)
    for v in (vec, torch.from_numpy(vec)):
        for name in jplan.layout():
            _bits(tplan.answer(v, name), jplan.answer(vec, name), name)
        for t in ("k8", "dashboard"):
            _bits(tplan.tenant_answers(v, t), jplan.tenant_answers(vec, t),
                  t)
    with pytest.raises(KeyError):
        tplan.tenant_answers(vec, "nope")


def _padded_layout(plan) -> dict:
    """Every tenant's queries at their PADDED offsets (slot order)."""
    out = {}
    for name in plan.tenant_names:
        base, _ = plan.padded_slice(name)
        for q, (o, w, kind) in plan.plan_for(name).layout().items():
            out[f"{name}/{q}"] = (base + o, w, kind)
    return out


def test_plan_cache_and_signatures():
    sig = TC.canonical_signature(_small(TReg).specs)
    assert [sp.name for sp in sig] == [f"q{i}" for i in range(8)]
    assert [(sp.name, sp.kind) for sp in sig] == [
        (sp.name, sp.kind) for sp in JC.canonical_signature(
            _small(JReg).specs)]
    assert [TC.slot_bucket(n) for n in (0, 1, 2, 3, 5, 8, 9)] == \
        [JC.slot_bucket(n) for n in (0, 1, 2, 3, 5, 8, 9)]
    before = TC.plan_cache_stats()
    TC.build_slotted_plan([("u", _small(TReg).specs)], 4)
    TC.build_slotted_plan([("v", _small(TReg).specs)], 4)
    after = TC.plan_cache_stats()
    assert after["hits"] >= before["hits"] + 1
    assert TReg.from_tokens("sum,hist:0:10:4,q:0.5,hh:4,wq:0.9,dhh:2:0.5"
                            ).specs == tuple(
        TReg().register_sum().register_histogram("hist", 0, 10, 4)
        .register_quantile("quantile", (0.5,)).register_heavy_hitters(
            "hh", k=4).register_windowed_quantile("wq", (0.9,))
        .register_decayed_heavy_hitters("dhh", k=2, decay=0.5).specs)


# ------------------------------------------------------------- pipeline --
def _spec(tenants=True, seed=3):
    return J.PipelineSpec(
        topology=J.TopologySpec(fanin=(4, 2, 1), capacity=512,
                                num_strata=4),
        sampler=J.SamplerSpec(backend="pallas_fused", fraction=0.1),
        tenants=((_k8(JReg).as_tenant("k8"),
                  _dashboard(JReg).as_tenant("dashboard"))
                 if tenants else ()),
        telemetry=J.TelemetrySpec(enabled=True), seed=seed)


def _ingest(seed, ticks=6):
    sources = [S.StreamSource(S.paper_gaussian(rates=(60,) * 4),
                              seed=seed + i) for i in range(8)]
    return S.batch_ingest(sources, ticks, 4, 512)


@pytest.fixture(scope="module")
def two_tenant_runs():
    """Two epochs of the two-tenant spec on both packages."""
    jspec = _spec()
    jp = J.compile(jspec)
    tp = P.compile(P.PipelineSpec.from_dict(jspec.to_dict()), device="cpu")
    js, ts = jp.init(), tp.init()
    epochs = []
    for e in range(2):
        b = _ingest(10 * e)
        js, jwa = jp.run_epoch(js, jp.default_key, b.values, b.strata,
                               b.counts)
        ts, twa = tp.run_epoch(ts, tp.default_key, b.values, b.strata,
                               b.counts)
        epochs.append((jwa, twa, jax.tree.map(np.asarray, js), ts, b))
    return jp, tp, epochs


def test_two_tenant_pipeline_matches_reference(two_tenant_runs):
    jp, tp, epochs = two_tenant_runs
    assert tp.query_layout() == jp.query_layout()
    for jwa, twa, js, ts, _ in epochs:
        for f in ("tick", "ok", "sum", "sum_var", "mean", "mean_var",
                  "n_sampled", "histogram", "answers", "n_forwarded"):
            _bits(getattr(twa, f).numpy(), getattr(jwa, f), f)
        _compare_bounds(twa.bounds.numpy(), jwa.bounds, jp.query_layout())
        _compare_qstate(ts.tree.qstate, js.tree.qstate)
        for f in ("values", "strata", "fill", "w_in", "c_in"):
            for a, b in zip(getattr(ts.tree, f), getattr(js.tree, f)):
                _bits(a.numpy(), b, f)
        tel_t, tel_j = ts.tree.telemetry, js.tree.telemetry
        _compare_bounds(tel_t.slot_rel_bound_sum.numpy(),
                        tel_j.slot_rel_bound_sum, jp.query_layout())
        _bits(tel_t.windows.numpy(), tel_j.windows)
    # rows, per-tenant routing and attribution
    jwa, twa = epochs[-1][0], epochs[-1][1]
    trows, jrows = tp.rows(twa), jp.rows(jwa)
    assert len(trows) == len(jrows) == 6
    for tr, jr in zip(trows, jrows):
        assert tr.keys() == jr.keys()
        _bits(tr["answers"], jr["answers"])
        for tenant, q in (("k8", "quantiles"), ("k8", "heavy"),
                          ("dashboard", "latency_q_recent_ms"),
                          ("dashboard", "hot_latency_keys")):
            _bits(tp.answer(tr["answers"], q, tenant=tenant),
                  jp.answer(jr["answers"], q, tenant=tenant))
        _bits(tp.tenant_answers(tr["answers"], "dashboard"),
              jp.tenant_answers(jr["answers"], "dashboard"))
        assert tp.tenant_rel_errors(tr["answers"], tr["bounds"]) == \
            jp.tenant_rel_errors(jr["answers"], jr["bounds"])
    assert tp.query_layout("k8") == jp.query_layout("k8")
    with pytest.raises(KeyError):
        tp.answer(trows[0]["answers"], "nope", tenant="k8")


def test_root_not_due_answers_zeros_like_the_reference():
    """Levels flushing every 2 ticks: on a tick the root is not due the
    answers and bounds are zeros and the sketches keep their state."""
    jspec = J.PipelineSpec(
        topology=J.TopologySpec(fanin=(4, 2, 1), capacity=256, num_strata=4,
                                interval_ticks=(1, 2, 2)),
        sampler=J.SamplerSpec(backend="topk", allocation="neyman",
                              fraction=0.2),
        tenants=(_small(JReg).as_tenant("s"),),
        telemetry=J.TelemetrySpec(enabled=True), seed=8)
    b = S.batch_ingest([S.StreamSource(S.paper_gaussian(rates=(30,) * 4),
                                       seed=40 + i) for i in range(8)],
                       5, 4, 256)
    jp = J.compile(jspec)
    js, jwa = jp.run_epoch(jp.init(), jp.default_key, b.values, b.strata,
                           b.counts)
    tp = P.compile(P.PipelineSpec.from_dict(jspec.to_dict()), device="cpu")
    ts, twa = tp.run_epoch(tp.init(), tp.default_key, b.values, b.strata,
                           b.counts)
    _bits(twa.answers.numpy(), jwa.answers)
    _compare_bounds(twa.bounds.numpy(), jwa.bounds, jp.query_layout())
    _compare_qstate(ts.tree.qstate, jax.tree.map(np.asarray,
                                                 js.tree.qstate))
    due = twa.tick.numpy() % 2 == 0
    assert due.any() and (~due).any()
    assert not twa.answers.numpy()[~due].any()
    assert not twa.bounds.numpy()[~due].any()
    assert twa.answers.numpy()[due].any()


def test_registering_queries_leaves_samples_and_state_bitwise():
    b = _ingest(5)
    runs = []
    for tenants in (True, False):
        spec = P.PipelineSpec.from_dict(_spec(tenants).to_dict())
        tp = P.compile(spec, device="cpu")
        st, wa = tp.run_epoch(tp.init(), tp.default_key, b.values,
                              b.strata, b.counts)
        runs.append((st, wa))
    (s1, w1), (s0, w0) = runs
    for f in ("tick", "ok", "sum", "sum_var", "mean", "mean_var",
              "n_sampled", "histogram", "n_forwarded"):
        _bits(getattr(w1, f).numpy(), getattr(w0, f).numpy(), f)
    assert w0.answers is None and w1.answers.shape[0] == 6
    for f in s0.tree.LEVEL_FIELDS:
        for a, c in zip(getattr(s1.tree, f), getattr(s0.tree, f)):
            _bits(a.numpy(), c.numpy(), f)


def test_reset_queries_and_qstate_through_convert(two_tenant_runs):
    """The reference's state after epoch 1 (sketches included) carried
    into the port, epoch 2 on the port, against the reference's epoch 2;
    and back out to numpy."""
    jp, tp, epochs = two_tenant_runs
    js1 = epochs[0][2]
    ts = convert.state_from_numpy(js1)
    _compare_qstate(ts.tree.qstate, js1.tree.qstate)
    jwa2, _, js2, _, b2 = epochs[1]
    ts, twa = tp.run_epoch(ts, tp.default_key, b2.values, b2.strata,
                           b2.counts)
    _bits(twa.answers.numpy(), jwa2.answers)
    _compare_qstate(ts.tree.qstate, js2.tree.qstate)
    back = convert.state_to_numpy(ts)["tree"]["qstate"]
    for (mask, sks), (jmask, jsks) in zip(back, js2.tree.qstate):
        _bits(mask, jmask)
        for sk, jsk in zip(sks, jsks):
            if jsk == ():
                assert sk == ()
                continue
            for f in jsk._fields:
                _bits(sk[f], getattr(jsk, f), f)
    again = convert.state_from_numpy({"tree": dict(
        convert.state_to_numpy(ts)["tree"]), "tick": np.int32(13)})
    _compare_qstate(again.tree.qstate, js2.tree.qstate)
    empty = tp.reset_queries(ts)
    _compare_qstate(empty.tree.qstate,
                    jax.tree.map(np.asarray, jp.plan.init_state()))


def test_spec_with_tenants_round_trips_and_keeps_the_checks():
    jspec = _spec()
    spec = P.PipelineSpec.from_dict(jspec.to_dict())
    assert spec.to_dict() == jspec.to_dict()
    assert [t.name for t in spec.tenants] == ["k8", "dashboard"]
    assert spec.tenants[0] == _k8(TReg).as_tenant("k8")
    d = jspec.to_dict()
    d["sampler"]["mode"] = "srs"
    with pytest.raises(P.SpecError, match="WHS stratum metadata"):
        P.PipelineSpec.from_dict(d)
    d = jspec.to_dict()
    d["budget"]["target_rel_error"] = 0.001
    with pytest.raises(P.SpecError, match="bottoms out at rank error"):
        P.PipelineSpec.from_dict(d)
    d = jspec.to_dict()
    d["tenants"][1]["name"] = "k8"
    with pytest.raises(P.SpecError, match="duplicate tenant names"):
        P.PipelineSpec.from_dict(d)
    d = jspec.to_dict()
    d["tenants"][0]["queries"][0]["bogus"] = 1
    with pytest.raises(P.SpecError, match="unknown keys"):
        P.PipelineSpec.from_dict(d)
    r = P.resolve(spec)
    assert r.plan.n_out == J.resolve(jspec).plan.n_out
    assert P.resolve(P.PipelineSpec()).plan is None
