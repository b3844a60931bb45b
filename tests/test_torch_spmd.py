"""The port's mesh data plane against the reference's SPMD functions.

``repro_torch.compile(spec, mesh=make_data_mesh(n, ...))`` runs on real
``torch.distributed`` ranks here: ``spawn_ranks`` starts N gloo rank
processes on the CPU, each rank runs ``tests/torch_spmd_ranks.py``, and
one spawn per world size (1, 2, 4) feeds every assertion.

The reference side is the reference's own SPMD functions
(``core.tree.spmd_query_plane_epoch``, ``spmd_local_then_root_epoch``,
``spmd_srs_epoch``) under ``jax.jit(jax.vmap(f, axis_name="data"))``
over a leading axis of N shards, with the state ``plan.init_state()``
stacked N times. vmap, not ``shard_map``: on jax 0.9.0 the reference's
tenant path fails under ``shard_map`` at every device count with a
varying-manual-axes mismatch in the ``lax.cond`` at
``query/sketches.py:242`` (ROADMAP Watch list); under a named vmap axis
``psum``, ``pmin``, ``pmax``, ``all_gather`` and ``axis_index`` mean the
same, and the reference is unchanged.

Bitwise: keep masks and counts, exact counts, the built-in histogram,
every quantile and heavy-hitter answer, the sketch states, the gathered
reservoirs' results at N = 1. Two tolerances, each with its cause:

* ``RANK_FOLD_RTOL``: a float sum across ranks. The port adds each
  rank's estimate, then folds the ranks in order (what a collective
  does); under vmap XLA fuses the cross-rank sum into the per-rank sum
  over strata, one FMA chain over every (rank, stratum) product, which
  rounds once less per rank boundary (checked by hand at N = 2). At most
  one rounding of the result per rank: ``N · 2^-24``, so 2^-22 at N ≤ 4.
* ``TOTAL_RTOL``: the heavy-hitter bound's ``Σ counts`` and the SRS
  sums, ``torch.sum`` against XLA's reduction order (ROADMAP Watch list,
  "Sums the port cannot order"), as in the port's other tests.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import spec as JSPEC  # noqa: E402
from repro.api.spec import (PipelineSpec, SamplerSpec, TelemetrySpec,  # noqa: E402
                            TenantSpec, TopologySpec)
from repro.core import tree as JT  # noqa: E402
from repro.core.types import IntervalBatch, StratumMeta  # noqa: E402
from repro.data import stream as JS  # noqa: E402
from repro.query.registry import QueryRegistry  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

import torch_spmd_ranks as R  # noqa: E402

X, T, M = 3, 4, 8192
HEAVY = np.array([7, 13, 29, 101], np.int64)
RANK_FOLD_RTOL = 2.0 ** -22
TOTAL_RTOL = 1e-5
RANK_TIMEOUT_S = 240.0


def _stream():
    rng = np.random.default_rng(0)
    vals = np.where(
        rng.random((T, M)) < 0.55,
        rng.choice(HEAVY, p=[0.5, 0.3, 0.15, 0.05], size=(T, M)),
        np.round(rng.normal(50.0, 9.0, (T, M)))).astype(np.float32)
    strs = rng.integers(0, X, (T, M)).astype(np.int32)
    return vals, strs


VALS, STRS = _stream()


def _tenants():
    a = (QueryRegistry().register_sum().register_count().register_mean()
         .register_quantile("q", (0.5, 0.9), capacity=64)
         .register_heavy_hitters("hh", k=4, width=64, depth=2))
    b = (QueryRegistry().register_count("n")
         .register_histogram("h", 0.0, 128.0, 16))
    return (TenantSpec.from_registry("a", a),
            TenantSpec.from_registry("b", b))


def _spec(fraction=0.25, mode="whs", backend="topk", allocation="fair",
          tenants=None, num_strata=X, telemetry=False, capacity=M // 8):
    return PipelineSpec(
        topology=TopologySpec(fanin=(4, 2, 1), capacity=capacity,
                              num_strata=num_strata),
        sampler=SamplerSpec(mode=mode, backend=backend, fraction=fraction,
                            allocation=allocation),
        tenants=_tenants() if tenants is None else tenants,
        telemetry=TelemetrySpec(enabled=telemetry), seed=0)


FREE = {  # name → (tenant-free spec, world sizes held against the ref)
    "topk-fair": (_spec(tenants=()), (1, 2, 4)),
    "topk-neyman": (_spec(tenants=(), allocation="neyman"), (1, 2, 4)),
    # the reference's Pallas kernels run in interpret mode under vmap
    "pallas_fused-neyman": (_spec(tenants=(), backend="pallas_fused",
                                  allocation="neyman"), (2,)),
    "pallas-fair": (_spec(tenants=(), backend="pallas"), (2,)),
}
SRS = _spec(mode="srs", tenants=())
# budget == shard on 4 ranks, as the reference's harness has it on 8
EXACT = _spec(fraction=1.0, num_strata=1, capacity=M // 4)
# the recency kinds the serve dashboard registers, on 2 ranks
KINDS = _spec(tenants=(QueryRegistry().register_count("n")
                       .register_windowed_quantile("w", (0.5, 0.9),
                                                   capacity=32, window=2)
                       .register_decayed_heavy_hitters("d", k=4, width=64,
                                                       decay=0.8)
                       .as_tenant("r"),))
CHURN_SPEC = _spec(tenants=(TenantSpec.from_registry(
    "x", QueryRegistry().register_sum().register_count()),))
CHURN_ADMIT = QueryRegistry().register_count("n").register_quantile(
    "p", (0.5,), capacity=16).as_tenant("y")


def _job(n, ckpt_root):
    job = dict(values=VALS, strata=STRS, tenant=_spec().to_dict(),
               resume=True,
               free={k: s.to_dict() for k, (s, ns) in FREE.items()
                     if n in ns})
    job["free"]["srs"] = SRS.to_dict()
    if n == 2:
        job.update(
            errors=True, metrics=_spec(telemetry=True).to_dict(),
            kinds=KINDS.to_dict(),
            churn=dict(spec=CHURN_SPEC.to_dict(), retire="x",
                       admit=(CHURN_ADMIT.name,
                              [dataclasses.asdict(q)
                               for q in CHURN_ADMIT.queries])),
            ckpt=dict(spec=_spec().to_dict(), root=str(ckpt_root)))
    if n == 4:
        job["exact"] = EXACT.to_dict()
    return job


def _spawn_all(roots):
    return {n: spawn_ranks(R.run_rank, n, args=(n, "cpu", "gloo",
                                                _job(n, roots[n])),
                           device="cpu", backend="gloo",
                           timeout_s=RANK_TIMEOUT_S)
            for n in (1, 2, 4)}


@pytest.fixture(scope="module")
def _port_running(tmp_path_factory):
    """The port's rank processes, started in a thread so that they run
    while the reference compiles (``ref``)."""
    roots = {n: tmp_path_factory.mktemp(f"ckpt{n}") for n in (1, 2, 4)}
    with ThreadPoolExecutor(max_workers=1) as pool:
        yield pool.submit(_spawn_all, roots)


@pytest.fixture(scope="module")
def port(_port_running, ref):
    """{N: [rank 0's results, rank 1's, ...]} from one spawn per N."""
    return _port_running.result(timeout=3 * RANK_TIMEOUT_S)


# ------------------------------------------------------------ reference --
def _shards(n, vals=VALS, strs=STRS, x=X):
    b = JS.rows_to_interval_batch(vals, strs, np.full((len(vals),), M), x)
    t = len(vals)

    def split(v):
        return jnp.moveaxis(v.reshape(t, n, M // n), 1, 0)

    return IntervalBatch(split(b.value), split(b.stratum), split(b.valid),
                         StratumMeta(jnp.stack([b.meta.weight] * n),
                                     jnp.stack([b.meta.count] * n)))


def _stack(tree, n):
    return jax.tree.map(lambda v: jnp.stack([v] * n), tree)


def ref_tenant_epoch(spec, n, plan, qstate, t0=0, lo=0, hi=None):
    """The reference's tenant epoch under vmap → (q', host outputs with
    the answers compacted to the public vector)."""
    r = JSPEC.resolve(spec)
    key = jax.random.PRNGKey(spec.seed)

    def f(q, bt):
        return JT.spmd_query_plane_epoch(
            key, jnp.int32(t0), jnp.float32(r.sample_sizes[0]), bt, q,
            plan.core, axis_name="data",
            max_budget=int(r.max_sample_sizes[0]),
            num_strata=spec.topology.num_strata,
            allocation=spec.sampler.allocation,
            sampler_backend=spec.sampler.backend)

    bt = _shards(n, VALS[lo:hi], STRS[lo:hi], spec.topology.num_strata)
    qf, outs = jax.jit(jax.vmap(f, axis_name="data"))(qstate, bt)
    ok, se, sv, me, mv, nsel, hist, ans, bnd = (np.asarray(o) for o in outs)
    for o in (ok, se, sv, nsel, hist, ans):   # replicated in value
        assert (o == o[:1]).all()
    return qf, dict(ok=ok[0], sum=se[0], sum_var=sv[0], mean=me[0],
                    mean_var=mv[0], n_sampled=nsel[0], histogram=hist[0],
                    answers=np.asarray(plan.compact(ans[0])),
                    bounds=np.asarray(plan.compact(bnd[0])))


def ref_free(spec, n):
    r = JSPEC.resolve(spec)
    key = jax.random.PRNGKey(spec.seed)
    if spec.sampler.mode == "srs":
        def f(bt):
            return JT.spmd_srs_epoch(key, bt, axis_name="data",
                                     fraction=float(spec.sampler.fraction))
    else:
        def f(bt):
            return JT.spmd_local_then_root_epoch(
                key, bt, axis_name="data", num_strata=X,
                local_budget=int(r.sample_sizes[0]),
                root_budget=int(r.sample_sizes[-1]),
                allocation=spec.sampler.allocation,
                sampler_backend=spec.sampler.backend)
    s, m = jax.jit(jax.vmap(f, axis_name="data"))(_shards(n))
    return dict(sum=np.asarray(s.estimate)[0],
                sum_var=np.asarray(s.variance)[0],
                mean=np.asarray(m.estimate)[0],
                mean_var=np.asarray(m.variance)[0])


@pytest.fixture(scope="module")
def ref(_port_running):
    out = {"tenant": {}, "free": {}}
    spec = _spec()
    plan = JSPEC.resolve(spec).plan
    for n in (1, 2, 4):
        qf, outs = ref_tenant_epoch(spec, n, plan,
                                    _stack(plan.init_state(), n))
        out["tenant"][n] = dict(outs, qstate=[
            np.asarray(v) for v in jax.tree.leaves(qf)])
    for name, (s, ns) in FREE.items():
        for n in ns:
            out["free"][(name, n)] = ref_free(s, n)
    for n in (1, 2, 4):
        out["free"][("srs", n)] = ref_free(SRS, n)
    plan = JSPEC.resolve(KINDS).plan
    qf, outs = ref_tenant_epoch(KINDS, 2, plan, _stack(plan.init_state(), 2))
    out["kinds"] = dict(outs, qstate=[np.asarray(v)
                                      for v in jax.tree.leaves(qf)])
    # churn at N = 2: epoch A, admit y, epoch B, retire x, epoch C
    plan = JSPEC.resolve(CHURN_SPEC).plan
    q = _stack(plan.init_state(), 2)
    layouts = {"A": plan.layout()}
    q, a = ref_tenant_epoch(CHURN_SPEC, 2, plan, q, hi=2)
    plan, tf = plan.admit(CHURN_ADMIT.name, tuple(CHURN_ADMIT.queries))
    q = tf(q, 1)
    admitted = [np.asarray(v) for v in jax.tree.leaves(q)]
    layouts["B"] = plan.layout()
    q, b = ref_tenant_epoch(CHURN_SPEC, 2, plan, q, t0=2, lo=2)
    plan, tf = plan.retire("x")
    q = tf(q, 1)
    layouts["C"] = plan.layout()
    q, c = ref_tenant_epoch(CHURN_SPEC, 2, plan, q, t0=4, hi=2)
    out["churn"] = dict(A=a, B=b, C=c, admitted=admitted, layouts=layouts,
                        qstate=[np.asarray(v) for v in jax.tree.leaves(q)])
    return out


# ---------------------------------------------------------------- checks --
BITWISE = ("ok", "n_sampled", "histogram")
FOLDED = ("sum", "sum_var", "mean", "mean_var")


def _bits(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _close(a, b, rtol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=0, err_msg=what)


def _slots(layout, kinds):
    """Public-vector columns of the queries of ``kinds``."""
    cols = []
    for _, (o, w, kind) in layout.items():
        if kind in kinds:
            cols.extend(range(o, o + w))
    return np.asarray(sorted(cols), int)


SKETCHES = ("quantile", "windowed_quantile", "heavy_hitters",
            "decayed_heavy_hitters")


def _check_answers(got, want, layout, what):
    for k in BITWISE:
        _bits(got[k], want[k], f"{what}: {k}")
    for k in FOLDED:
        _close(got[k], want[k], RANK_FOLD_RTOL, f"{what}: {k}")
    exact = _slots(layout, ("count", "histogram") + SKETCHES)
    clt = _slots(layout, ("sum", "mean"))
    _bits(got["answers"][:, exact], want["answers"][:, exact],
          f"{what}: sketch, count and histogram answers")
    _close(got["answers"][:, clt], want["answers"][:, clt], RANK_FOLD_RTOL,
           f"{what}: CLT answers")
    # bounds: counts 0, quantile rank bounds bitwise; CLT bounds folded;
    # the heavy-hitter ε·W bound from Σ counts (torch.sum)
    ranked = _slots(layout, ("count", "quantile", "windowed_quantile"))
    _bits(got["bounds"][:, ranked], want["bounds"][:, ranked],
          f"{what}: count and quantile bounds")
    _close(got["bounds"][:, clt], want["bounds"][:, clt], RANK_FOLD_RTOL,
           f"{what}: CLT bounds")
    rest = _slots(layout, ("histogram", "heavy_hitters",
                           "decayed_heavy_hitters"))
    _close(got["bounds"][:, rest], want["bounds"][:, rest], TOTAL_RTOL,
           f"{what}: histogram and heavy-hitter bounds")


def test_every_rank_holds_the_same_answers(port):
    for n, ranks in port.items():
        assert [r["rank"] for r in ranks] == list(range(n))
        for r in ranks[1:]:
            for k, v in ranks[0]["tenant"]["wa"].items():
                _bits(r["tenant"]["wa"][k], v, f"N={n} rank {r['rank']} {k}")
            for name, res in ranks[0]["free"].items():
                for k in ("sum", "sum_var", "mean", "mean_var"):
                    _bits(r["free"][name][k], res[k], f"N={n} {name} {k}")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_tenant_plane_matches_reference(port, ref, n):
    got = port[n][0]["tenant"]
    _check_answers(got["wa"], ref["tenant"][n], got["layout"],
                   f"tenant N={n}")
    assert got["tick"] == T
    _bits(got["wa"]["tick"], np.arange(T), "ticks")


def test_recency_kinds_match_reference(port, ref):
    """The windowed quantile (every rank's ring gathered and merged as one
    stack) and the decayed heavy hitters (decayed tables summed) on 2
    ranks."""
    for r in port[2]:
        got = r["kinds"]
        _check_answers(got["wa"], ref["kinds"], got["layout"],
                       f"kinds rank {r['rank']}")
        for g, w in zip(got["qstate"], ref["kinds"]["qstate"]):
            _bits(g, w[r["rank"]:r["rank"] + 1], "kinds rows")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_each_rank_sketch_state_is_reference_row(port, ref, n):
    want = ref["tenant"][n]["qstate"]
    for r in port[n]:
        got = r["tenant"]["qstate"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _bits(g, w[r["rank"]:r["rank"] + 1], f"N={n} rank {r['rank']}")


@pytest.mark.parametrize("name,n", [(k, n) for k, (_, ns) in FREE.items()
                                    for n in ns])
def test_tenant_free_path_matches_reference(port, ref, name, n):
    got = port[n][0]["free"][name]
    want = ref["free"][(name, n)]
    rtol = 0.0 if n == 1 else RANK_FOLD_RTOL
    for k in ("sum", "sum_var", "mean", "mean_var"):
        _close(got[k], want[k], rtol, f"{name} N={n} {k}")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_srs_path_matches_reference(port, ref, n):
    got = port[n][0]["free"]["srs"]
    want = ref["free"][("srs", n)]
    for k in ("sum", "sum_var", "mean", "mean_var"):
        _close(got[k], want[k], TOTAL_RTOL, f"srs N={n} {k}")


# ------------------------------------------------------- the reference's law
def _exact():
    return dict(sum=VALS.sum(axis=1, dtype=np.float64),
                mean=VALS.mean(axis=1, dtype=np.float64))


def _slice(wa, layout, name):
    o, w, _ = layout[name]
    return wa["answers"][..., o:o + w], wa["bounds"][..., o:o + w]


def test_exact_queries_bitwise_across_rank_counts(port):
    lay = port[1][0]["tenant"]["layout"]
    want = {}
    for name in ("a/count", "b/n"):
        want[name], _ = _slice(port[1][0]["tenant"]["wa"], lay, name)
        _bits(want[name][:, 0], np.full(T, float(M)), name)
    for n in (2, 4):
        wa = port[n][0]["tenant"]["wa"]
        for name in ("a/count", "b/n"):
            a, b = _slice(wa, lay, name)
            _bits(a, want[name], f"{name} N={n}")
            _bits(b, 0.0, f"{name} bound N={n}")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_clt_answers_within_published_bounds(port, n):
    wa = port[n][0]["tenant"]["wa"]
    lay = port[n][0]["tenant"]["layout"]
    ex = _exact()
    a, b = _slice(wa, lay, "a/sum")
    assert np.all(np.abs(a[:, 0] - ex["sum"]) <= 2 * b[:, 0] + 1e-3)
    assert np.all(b[:, 0] > 0.0)
    a, b = _slice(wa, lay, "a/mean")
    assert np.all(np.abs(a[:, 0] - ex["mean"]) <= 2 * b[:, 0] + 1e-3)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_histogram_tenant_exact_at_full_mass(port, n):
    h, _ = _slice(port[n][0]["tenant"]["wa"],
                  port[n][0]["tenant"]["layout"], "b/h")
    np.testing.assert_allclose(h.sum(axis=-1), float(M), rtol=1e-4)


def _ranks_so_far(row, t):
    seen = VALS[:t + 1].reshape(-1)
    return [float((seen <= v).mean()) for v in row]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_quantiles_within_published_rank_bounds(port, n):
    a, b = _slice(port[n][0]["tenant"]["wa"],
                  port[n][0]["tenant"]["layout"], "a/q")
    ranks = np.asarray([_ranks_so_far(a[t], t) for t in range(T)])
    # CLT slack of the sampled fold-in, as the reference's law allows
    assert np.all(np.abs(ranks - [0.5, 0.9]) <= b + 0.06), (ranks, b)


def _true_counts(t):
    keys, cnt = np.unique(np.round(VALS[:t + 1].reshape(-1)),
                          return_counts=True)
    return {int(k): int(c) for k, c in zip(keys, cnt)}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_heavy_hitters_found_at_every_rank_count(port, n):
    """The merged top-k finds the heavy keys, each estimate within the
    count-min bound plus the HT sampling slack. At N = 1 the fourth key,
    101 (2.75% of the stream), is within the count-min bound (2/64 of the
    weight, 3.1%) of key 50 (2.0%) and loses its slot to it: the
    reference's answers there, which
    ``test_tenant_plane_matches_reference[1]`` holds bitwise, miss it
    too. The three keys above the bound's reach are found at every N,
    all four at N = 2 and 4."""
    a, b = _slice(port[n][0]["tenant"]["wa"],
                  port[n][0]["tenant"]["layout"], "a/hh")
    found = set(a[-1, :4].astype(np.int64).tolist())
    assert set(HEAVY[:3].tolist()) <= found
    if n > 1:
        assert found == set(HEAVY.tolist())
    true = _true_counts(T - 1)
    w_total = sum(true.values())
    for k, e in zip(a[-1, :4].astype(np.int64), a[-1, 4:]):
        assert abs(e - true[int(k)]) <= b[-1, 4] + 0.05 * w_total


def test_exact_regime_is_tight(port):
    """Fraction 1.0 on 4 ranks, one stratum (the budget covers each
    shard): every weight is 1, SUM is the exact sum, the quantile ranks
    meet their bound with no sampling slack and the heavy-hitter
    estimates only over-count, within the count-min bound."""
    got = port[4][0]["exact"]
    assert got["local_budget"] == M // 4
    wa, lay = got["wa"], port[4][0]["tenant"]["layout"]
    a, _ = _slice(wa, lay, "a/sum")
    _bits(a[:, 0], VALS.sum(axis=1, dtype=np.float32), "exact SUM")
    a, b = _slice(wa, lay, "a/q")
    ranks = np.asarray([_ranks_so_far(a[t], t) for t in range(T)])
    assert np.all(np.abs(ranks - [0.5, 0.9]) <= b + 1e-6), (ranks, b)
    a, b = _slice(wa, lay, "a/hh")
    for t in range(T):
        true = _true_counts(t)
        for k, e in zip(a[t, :4].astype(np.int64), a[t, 4:]):
            tk = true.get(int(k), 0)
            assert tk - 1e-3 <= e <= tk + b[t, 4] + 1e-3, (t, k, e, tk)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_two_epochs_of_two_equal_one_of_four(port, n):
    r = port[n][0]
    one = r["tenant"]["wa"]
    a, b = r["resume"]
    for k in ("tick", "answers", "bounds", "sum", "n_sampled"):
        _bits(np.concatenate([a[k], b[k]]), one[k], f"N={n} {k}")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_srs_within_bounds(port, n):
    got = port[n][0]["free"]["srs"]
    ex = _exact()
    assert np.all(np.abs(got["sum"] - ex["sum"])
                  <= 3 * np.sqrt(got["sum_var"]))
    assert np.all(np.abs(got["mean"] - ex["mean"])
                  <= 3 * np.sqrt(got["mean_var"]) + 1e-3)


def test_spec_errors(port):
    errs = port[2][0]["errors"]
    assert "divide evenly" in errs["indivisible"]
    assert "tenant" in errs["no_budgets"]
    assert errs["clamp"] == float(port[2][0]["tenant"]["local_budget"])


# ------------------------------------------------------------ what crosses
@pytest.mark.parametrize("n", [2, 4])
def test_only_sketch_summaries_cross_ranks(port, n):
    """With tenants no collective's operand is as large as a shard: the
    largest is the leveled quantile buffer (levels × capacity = 4 × 64)
    or the 2 × 64 count-min table."""
    ledger = port[n][0]["tenant"]["ledger"]
    names = {name for name, _, _, _ in ledger}
    assert {"psum", "all_gather", "pmin", "pmax"} <= names
    largest = max(elems for _, elems, _, _ in ledger)
    assert largest <= max(2 * 64, 4 * 64)
    assert largest < M // n


@pytest.mark.parametrize("n", [2, 4])
def test_tenant_free_gather_is_the_compacted_reservoir(port, n):
    got = port[n][0]["free"]["topk-fair"]
    gathers = [e for name, e, _, _ in got["ledger"] if name == "all_gather"]
    # value, stratum and valid of the compacted reservoir, each window
    assert gathers == [got["local_budget"]] * 3 * T
    assert max(e for _, e, _, _ in got["ledger"]) == got["local_budget"]


# ------------------------------------------------------- churn and ckpts
def test_admit_then_retire_matches_reference(port, ref):
    """Epoch A with tenant x, admit y (a new slot group: its rows start
    empty on every rank), epoch B, retire x, epoch C: every epoch's
    answers are the reference's, and each rank's rows its row."""
    want = ref["churn"]
    for r in port[2]:
        got = r["churn"]
        for ep in ("A", "B", "C"):
            _check_answers(got[ep], want[ep], want["layouts"][ep],
                           f"churn {ep} rank {r['rank']}")
        for g, w in zip(got["admitted_qstate"], want["admitted"]):
            _bits(g, w[r["rank"]:r["rank"] + 1], "admitted rows")
        for g, w in zip(got["qstate"], want["qstate"]):
            _bits(g, w[r["rank"]:r["rank"] + 1], "rows after retire")
        assert got["layout"] == want["layouts"]["C"]


def test_checkpoint_resumes_bitwise_in_reference_layout(port):
    spec = _spec()
    plan = JSPEC.resolve(spec).plan
    want_shapes = [(), ] + [(2,) + tuple(np.shape(v))
                            for v in jax.tree.leaves(plan.init_state())]
    for r in port[2]:
        got = r["ckpt"]
        assert got["has_slots"]
        assert got["shapes"] == want_shapes
        for g, w in zip(got["restored"], got["state"]):
            _bits(g, w, f"restored rank {r['rank']}")
        for k, v in got["direct"].items():
            _bits(got["resumed"][k], v, f"resumed {k}")


# ----------------------------------------------------------------- metrics
def test_spmd_metric_families_and_merge_bytes(port):
    got = port[2][0]["metrics"]
    fams = {line.split()[2] for line in got["text"].splitlines()
            if line.startswith("# TYPE")}
    ref_names = {"repro_spmd_summary_bytes_total",
                 "repro_spmd_program_cache_misses_total",
                 "repro_spmd_program_cache_hits_total",
                 "repro_spmd_program_cache_hit_rate",
                 "repro_spmd_summary_bytes_per_window",
                 "repro_spmd_reservoir_bytes_per_window",
                 "repro_epoch_traces_total"}
    assert ref_names <= fams, ref_names - fams
    assert got["windows"] == T
    assert got["snapshot"]["merge_bytes"] == T * got["summary_bytes"]


def test_placements_state_the_reference_partition_specs():
    """``launch.sharding``'s placements are the reference's
    ``PartitionSpec``s over the "data" axis: ``P("data")`` a per-rank
    row, ``P(None, "data")`` the item split, ``P()`` replicated."""
    from jax.sharding import PartitionSpec as JP

    from repro.launch import sharding as JSH
    from repro_torch.launch import sharding as TSH

    words = {JP("data"): TSH.PER_RANK, JP(None, "data"): TSH.ITEM_SPLIT,
             JP(): TSH.REPLICATED}

    def said(tree):
        return [words[p] for p in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, JP))]

    plan = JSPEC.resolve(_spec()).plan
    j_in, j_out = JSH.spmd_epoch_specs("data")
    t_in, t_out = TSH.spmd_epoch_specs("data")
    assert said((j_in, j_out)) == list(jax.tree.leaves((t_in, t_out)))
    j = JSH.spmd_query_epoch_specs("data", plan.init_state())
    t_plan = R.api.resolve(R.PipelineSpec.from_dict(
        _spec().to_dict())).plan
    t = TSH.spmd_query_epoch_specs("data", t_plan.init_state())
    for part in ("qstate", "batches"):
        assert said(j[part]) == list(jax.tree.leaves(t[part])), part
    assert words[j["replicated"]] == t["replicated"]


@pytest.mark.parametrize("hang", [False, True])
def test_a_failing_or_hanging_rank_fails_the_spawn(hang):
    """A rank that raises fails the spawn with its error while rank 0 is
    blocked in a collective; a rank that never arrives fails it at the
    timeout. Neither holds the suite."""
    import time

    t0 = time.monotonic()
    # hanging: the spawn's deadline, or rank 0's collective timing out
    # first, whichever comes first; both are bounded by the timeout.
    # failing: rank 1's error, or rank 0's collective failing as rank 1's
    # connection closes, whichever the spawn sees first
    with pytest.raises(Exception, match="(?i)did not finish|timed out"
                       if hang else "planted failure|Process 0 terminated"):
        spawn_ranks(R.fail_or_wait, 2, args=(2, hang), device="cpu",
                    backend="gloo", timeout_s=5.0 if hang else 30.0)
    assert time.monotonic() - t0 < 45.0
