"""Tenant churn in the port: ``admit``/``retire`` as state edits, on the CPU.

The local laws of the reference's ``tests/test_tenant_slots.py`` on the
port — a churned pipeline answers bitwise as a fresh compile of the same
live set, retired slots never touch the live tenants' answers, bounds or
error attribution, churn inside a bucket builds no program and a bucket
boundary one, a checkpoint refuses a differently churned pipeline — and
one churn sequence run through both packages from the same ingest: the
port's answers, ``slot_manifest`` and ``tenant_names`` equal the
reference's, bitwise but for the sketches' bounds (``TOTAL_RTOL``, a sum
over the sketch's weights in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.query.registry import QueryRegistry as JQ  # noqa: E402
import repro_torch as tapi  # noqa: E402
from repro_torch import api as tapi_mod  # noqa: E402
from repro_torch.api.pipeline import program_cache_stats  # noqa: E402
from repro_torch.query import QueryRegistry as TQ  # noqa: E402

X = 3
TOTAL_RTOL = 1e-5


def _spec(api, tenants, seed=5, telemetry=False):
    return api.PipelineSpec(
        topology=api.TopologySpec(fanin=(4, 2, 1), capacity=768,
                                  num_strata=X),
        sampler=api.SamplerSpec(mode="whs", backend="topk"),
        tenants=tuple(tenants),
        budget=api.BudgetSpec(sample_sizes=(96, 96, 96)),
        telemetry=api.TelemetrySpec(enabled=telemetry), seed=seed)


def _reg_a(Q=TQ):
    return (Q().register_sum().register_mean()
            .register_quantile("q", (0.5, 0.9), capacity=64))


def _reg_b(Q=TQ):
    return (Q().register_count()
            .register_histogram("h", 0.0, 100.0, 8)
            .register_heavy_hitters("hh", k=4, width=256))


def _tenant(name, reg):
    return reg.as_tenant(name)


def _ingest(ticks=3, n0=4, width=400, seed=11):
    rng = np.random.default_rng(seed)
    vals = rng.normal(50, 9, (ticks, n0, width)).astype(np.float32)
    strs = rng.integers(0, X, (ticks, n0, width)).astype(np.int32)
    counts = rng.integers(100, width, (ticks, n0)).astype(np.int32)
    return vals, strs, counts


def _compile(tenants, **kw):
    return tapi.compile(_spec(tapi, tenants, **kw), device="cpu")


def _epoch(pipe, data, state=None):
    state = pipe.init() if state is None else state
    return pipe.run_epoch(state, pipe.default_key, *data)


def _same(a, b):
    assert torch.equal(a, b)


# ---------------------------------------------------- churn equivalence --
def test_admit_equivalence():
    """compile({a}) + admit(b) + admit(c) ≡ compile({a, b, c}), bitwise;
    c shares a's signature, so its admit doubles a's slot bucket."""
    data = _ingest()
    a, b = _tenant("alpha", _reg_a()), _tenant("beta", _reg_b())
    c = _tenant("gamma", _reg_a())
    fresh = _compile((a, b, c))
    _, w_fresh = _epoch(fresh, data)

    pipe = _compile((a,))
    state = pipe.init()
    pipe, state = pipe.admit(state, b)
    pipe, state = pipe.admit(state, c)
    state, w_churn = pipe.run_epoch(state, pipe.default_key, *data)

    assert pipe.tenant_names == fresh.tenant_names
    _same(w_churn.answers, w_fresh.answers)
    _same(w_churn.bounds, w_fresh.bounds)
    assert tuple(t.name for t in pipe.spec.tenants) == (
        "alpha", "beta", "gamma")
    with pytest.raises(tapi.SpecError, match="already admitted"):
        pipe.admit(state, a)


def test_retire_equivalence():
    """compile({a, b, c}) + retire(b) ≡ compile({a, c}), bitwise."""
    data = _ingest()
    a, b = _tenant("alpha", _reg_a()), _tenant("beta", _reg_b())
    c = _tenant("gamma", _reg_a())
    pipe = _compile((a, b, c))
    state = pipe.init()
    pipe, state = pipe.retire(state, "beta")
    state, w_churn = pipe.run_epoch(state, pipe.default_key, *data)
    fresh = _compile((a, c))
    _, w_fresh = _epoch(fresh, data)
    assert pipe.tenant_names == ("alpha", "gamma")
    _same(w_churn.answers, w_fresh.answers)
    _same(w_churn.bounds, w_fresh.bounds)
    with pytest.raises(tapi.SpecError):
        pipe.retire(state, "nope")
    solo = _compile((a,))
    with pytest.raises(tapi.SpecError, match="last live tenant"):
        solo.retire(solo.init(), "alpha")
    bare = tapi.compile(_spec(tapi, ()), device="cpu")
    with pytest.raises(tapi.SpecError, match="tenanted"):
        bare.admit(bare.init(), a)


def test_masked_slots_never_affect_active_tenants():
    """A retired neighbour (frozen, non-empty sketch state) is invisible:
    the live tenants' answers, bounds and error attribution are bitwise
    those of a never-churned pipeline."""
    from repro_torch.runtime.budget import aggregate_tenant_rel_errors

    data = _ingest()
    a, b = _tenant("alpha", _reg_a()), _tenant("beta", _reg_b())
    c = _tenant("gamma", _reg_a())
    pipe = _compile((a, b, c))
    state, _ = _epoch(pipe, data)
    pipe, state = pipe.retire(state, "gamma")
    state, w_churn = pipe.run_epoch(state, pipe.default_key, *data)

    ref = _compile((a, b))
    st_ref, _ = _epoch(ref, data)
    st_ref, w_ref = ref.run_epoch(st_ref, ref.default_key, *data)
    _same(w_churn.answers, w_ref.answers)
    _same(w_churn.bounds, w_ref.bounds)
    per = aggregate_tenant_rel_errors(pipe.plan, pipe.rows(w_churn))
    assert set(per) == {"alpha", "beta"}
    assert per == aggregate_tenant_rel_errors(ref.plan, ref.rows(w_ref))


def test_two_tenant_law_survives_any_bucket():
    """Slots padded well past the live count by churn, then masked: each
    live tenant still answers as its isolated single-tenant pipeline."""
    data = _ingest()
    a, b = _tenant("alpha", _reg_a()), _tenant("beta", _reg_b())
    pipe = _compile((a, b))
    state = pipe.init()
    for i in range(3):   # alpha's group: bucket 1 → 4
        pipe, state = pipe.admit(state, _tenant(f"pad{i}", _reg_a()))
    for i in range(3):
        pipe, state = pipe.retire(state, f"pad{i}")
    assert sum(n for _, n in pipe.plan.core.groups) >= 5
    state, w2 = pipe.run_epoch(state, pipe.default_key, *data)
    for t, reg in (("alpha", _reg_a()), ("beta", _reg_b())):
        solo = _compile((_tenant(t, reg),))
        _, w1 = _epoch(solo, data)
        np.testing.assert_array_equal(
            pipe.tenant_answers(w2.answers, t),
            w1.answers.numpy())
        np.testing.assert_array_equal(
            pipe.tenant_answers(w2.bounds, t),
            w1.bounds.numpy())


# ------------------------------------------------- programs under churn --
def test_churn_inside_a_bucket_builds_no_program():
    data = _ingest(ticks=2)
    pipe = _compile(tuple(_tenant(f"t{i}", _reg_a()) for i in range(8)))
    state, _ = _epoch(pipe, data)
    m0 = program_cache_stats()["misses"]
    tick_fn = pipe._tick_fn
    for i in range(4):
        pipe, state = pipe.retire(state, f"t{i}")
    for i in range(4):
        pipe, state = pipe.admit(state, _tenant(f"new{i}", _reg_a()))
    state, _ = pipe.run_epoch(state, pipe.default_key, *data)
    assert program_cache_stats()["misses"] == m0
    assert pipe._tick_fn is tick_fn


def test_one_program_per_bucket_boundary():
    data = _ingest(ticks=2)
    pipe = _compile((_tenant("t0", _reg_a()), _tenant("t1", _reg_a())),
                    seed=23)
    state, _ = _epoch(pipe, data)
    m0 = program_cache_stats()["misses"]
    pipe, state = pipe.admit(state, _tenant("t2", _reg_a()))   # 2 → 4
    state, _ = pipe.run_epoch(state, pipe.default_key, *data)
    assert program_cache_stats()["misses"] == m0 + 1
    pipe, state = pipe.admit(state, _tenant("t3", _reg_a()))   # inside 4
    state, _ = pipe.run_epoch(state, pipe.default_key, *data)
    assert program_cache_stats()["misses"] == m0 + 1


def test_telemetry_slot_leaf_follows_the_padded_width():
    data = _ingest(ticks=2)
    pipe = _compile((_tenant("alpha", _reg_a()),), telemetry=True)
    state, _ = _epoch(pipe, data)
    pipe, state = pipe.admit(state, _tenant("gamma", _reg_a()))
    assert state.tree.telemetry.slot_rel_bound_sum.shape == (
        pipe.plan.core.n_out,)
    state, _ = pipe.run_epoch(state, pipe.default_key, *data)
    assert torch.isfinite(state.tree.telemetry.slot_rel_bound_sum).all()


# ---------------------------------------------------- checkpoint slots --
def test_restore_rejects_differently_churned_pipeline(tmp_path):
    data = _ingest(ticks=2)
    a, b = _tenant("alpha", _reg_a()), _tenant("beta", _reg_b())
    pipe = _compile((a, b))
    state, _ = _epoch(pipe, data)
    tapi_mod.save_state(tmp_path, 1, state, pipeline=pipe)
    again = _compile((a, b))
    restored, _ = tapi_mod.restore_state(tmp_path, again, 1)
    from repro_torch.checkpoint.manager import _flatten

    for la, lb in zip(_flatten(state), _flatten(restored)):
        _same(la, lb)
    churned = _compile((a, b))
    churned, st2 = churned.admit(churned.init(), _tenant("gamma", _reg_a()))
    churned, st2 = churned.retire(st2, "gamma")
    with pytest.raises(tapi.SpecError, match="tenant-slot configuration"):
        tapi_mod.restore_state(tmp_path, churned, 1)


# ------------------------------------------------ against the reference --
def test_churn_sequence_is_the_reference():
    """admit, retire, re-admit into the freed slot, admit past a bucket,
    between epochs: answers, slot manifests and live names equal the
    reference's at every step."""
    data = _ingest(ticks=2, seed=4)

    def regs(Q):
        return {"a": _reg_a(Q), "b": _reg_b(Q)}

    steps = [("admit", "beta", "b"), ("admit", "gamma", "a"),
             ("retire", "alpha", None), ("admit", "delta", "a"),
             ("admit", "eps", "a"), ("retire", "beta", None)]
    both = []
    for api, Q in ((tapi, TQ), (japi, JQ)):
        r = regs(Q)
        spec = _spec(api, (r["a"].as_tenant("alpha"),))
        pipe = (api.compile(spec, device="cpu") if api is tapi
                else api.compile(spec))
        state, wa = pipe.run_epoch(pipe.init(), pipe.default_key, *data)
        trail = [(pipe.tenant_names, pipe.plan.slot_manifest(),
                  np.asarray(wa.answers), np.asarray(wa.bounds),
                  pipe.query_layout())]
        for op, name, reg in steps:
            if op == "admit":
                pipe, state = pipe.admit(state, r[reg].as_tenant(name))
            else:
                pipe, state = pipe.retire(state, name)
            state, wa = pipe.run_epoch(state, pipe.default_key, *data)
            trail.append((pipe.tenant_names, pipe.plan.slot_manifest(),
                          np.asarray(wa.answers), np.asarray(wa.bounds),
                          pipe.query_layout()))
        both.append(trail)
    for (tn, tm, ta, tb, tl), (jn, jm, ja, jb, jl) in zip(*both):
        assert tn == jn and tm == jm and tl == jl
        np.testing.assert_array_equal(ta.view(np.uint32), ja.view(np.uint32))
        sketch = [c for o, w, kind in jl.values()
                  if kind in ("quantile", "heavy_hitters")
                  for c in range(o, o + w)]
        exact = np.setdiff1d(np.arange(jb.shape[-1]), sketch)
        np.testing.assert_array_equal(tb[:, exact], jb[:, exact])
        np.testing.assert_allclose(tb[:, sketch], jb[:, sketch],
                                   rtol=TOTAL_RTOL)
