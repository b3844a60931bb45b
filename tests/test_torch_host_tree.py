"""The port's ``HostTree`` against the reference's, on the CPU.

Both trees get the same seeded ingest, tick by tick, on the ``level``
and ``loop`` engines: every result row (SUM, MEAN and their variances,
``n_sampled``, the histogram, the tenants' answers and bounds), the
forwarded counts, the dispatch counts and the sticky W/C sets must be
bitwise the reference's, for WHS and SRS, the three allocations and
every backend. The one exception is a quantile query's rank bound,
held to ``TOTAL_RTOL``: it divides by the sketch's total weight, an f32
sum over its slots that the reference's compiled reduction orders its
own way. The scan engine agrees with the level engine bitwise on
identical ingest.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.tree import HostTree as JTree  # noqa: E402
from repro.data import stream as JS  # noqa: E402
from repro.query.registry import QueryRegistry as JQ  # noqa: E402
from repro_torch.core.tree import HostTree as TTree  # noqa: E402
from repro_torch.data import stream as S  # noqa: E402
from repro_torch.query.registry import QueryRegistry as TQ  # noqa: E402

TOTAL_RTOL = 1e-5
TICKS = 3


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(np.asarray(a)), np.ascontiguousarray(
        np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def _kw(engine, backend, allocation="fair", mode="whs", iv=None):
    return dict(fanin=[4, 2, 1], num_strata=4, capacity=384,
                sample_sizes=[40, 40, 40], interval_ticks=iv,
                allocation=allocation, seed=7, mode=mode,
                fraction=0.2 if mode == "srs" else None, engine=engine,
                sampler_backend=backend)


def _registry(Q):
    return (Q().register_sum().register_count().register_mean()
            .register_histogram("h", 0.0, 2000.0, 8)
            .register_quantile("q", (0.5, 0.9), capacity=64))


def _drive(tree, ticks=TICKS, seed=0):
    sources = [JS.StreamSource(JS.paper_gaussian(rates=(30,) * 4),
                               seed=seed + i) for i in range(8)]
    for t in range(1, ticks + 1):
        for i, src in enumerate(sources):
            v, s = src.tick()
            tree.ingest(i % 4, v, s)
        tree.tick(t)
    return tree


def _compare(port, ref):
    assert len(port.results) == len(ref.results) > 0
    for p, r in zip(port.results, ref.results):
        assert p.keys() == r.keys()
        for k in ("tick", "sum", "sum_var", "mean", "mean_var", "n_sampled"):
            assert p[k] == r[k], k
        _bits(p["histogram"], r["histogram"], "histogram")
        if "answers" in r:
            _bits(p["answers"], r["answers"], "answers")
            o, w, _ = ref.plan.layout()["q"]
            clt = np.r_[0:o, o + w:len(r["bounds"])]
            _bits(p["bounds"][clt], r["bounds"][clt], "bounds")
            np.testing.assert_allclose(p["bounds"][o:o + w],
                                       r["bounds"][o:o + w], rtol=TOTAL_RTOL)
    assert port.items_forwarded == ref.items_forwarded
    assert port.items_ingested == ref.items_ingested
    assert port.dispatch_count == ref.dispatch_count
    for lp, lr in zip(port.levels, ref.levels):
        for a, b in (zip(lp, lr) if isinstance(lp, list) else [(lp, lr)]):
            _bits(a.w_in, b.w_in, "w_in")
            _bits(a.c_in, b.c_in, "c_in")


def _both(engine, backend, queries=False, **kw):
    ref = _drive(JTree(**_kw(engine, backend, **kw),
                       queries=_registry(JQ) if queries else None))
    port = _drive(TTree(**_kw(engine, backend, **kw),
                        queries=_registry(TQ) if queries else None,
                        device="cpu"))
    return port, ref


@pytest.mark.parametrize("engine,backend", [
    ("level", "argsort"), ("level", "topk"), ("level", "pallas"),
    ("level", "pallas_fused"), ("loop", "topk"), ("loop", "pallas")])
def test_host_tree_matches_reference(engine, backend):
    port, ref = _both(engine, backend)
    _compare(port, ref)
    assert port.dispatch_count == TICKS * (3 if engine == "level" else 7)


@pytest.mark.parametrize("engine,backend,allocation", [
    ("level", "pallas", "neyman"), ("level", "topk", "proportional"),
    ("loop", "argsort", "neyman"), ("loop", "pallas", "proportional")])
def test_host_tree_allocations_match_reference(engine, backend, allocation):
    port, ref = _both(engine, backend, allocation=allocation)
    _compare(port, ref)


@pytest.mark.parametrize("engine", ["level", "loop"])
def test_host_tree_srs_matches_reference(engine):
    port, ref = _both(engine, "topk", mode="srs")
    # The SRS root's SUM and MEAN are sums over the whole sample buffer,
    # which the reference's compiled reduction orders its own way.
    assert len(port.results) == len(ref.results) == TICKS
    for p, r in zip(port.results, ref.results):
        assert p["n_sampled"] == r["n_sampled"]
        np.testing.assert_allclose([p["sum"], p["mean"]],
                                   [r["sum"], r["mean"]], rtol=1e-5)
        np.testing.assert_allclose(p["histogram"], r["histogram"],
                                   rtol=1e-6)
    assert port.items_forwarded == ref.items_forwarded
    assert port.dispatch_count == ref.dispatch_count


@pytest.mark.parametrize("engine,backend", [("level", "topk"),
                                            ("loop", "pallas")])
def test_host_tree_with_queries_matches_reference(engine, backend):
    port, ref = _both(engine, backend, queries=True)
    _compare(port, ref)
    assert port.plan.layout() == ref.plan.layout()
    port.reset_query_state()
    fresh = port.plan.init_state(torch.device("cpu"))
    for (m, st), (fm, fst) in zip(port._qstate, fresh):
        assert torch.equal(m, fm)
        for a, b in zip(st, fst):
            for x, y in zip(a, b):
                assert torch.equal(x, y)


def test_host_tree_intervals_match_reference():
    """Levels flushing every 2 ticks: windows fold several messages and
    the sticky sets carry over skipped ticks."""
    port, ref = _both("level", "pallas", iv=[1, 2, 2])
    _compare(port, ref)


@pytest.mark.parametrize("backend", ["topk", "pallas"])
def test_scan_matches_level_on_identical_ingest(backend):
    """One epoch of the scan engine ≡ the level engine fed the same
    ingest tick by tick, to the bit; one dispatch for the epoch."""
    sources = [S.StreamSource(S.paper_gaussian(rates=(30,) * 4), seed=i)
               for i in range(8)]
    b = S.batch_ingest(sources, 4, 4, 384)
    level = TTree(**_kw("level", backend), device="cpu")
    for t in range(1, 5):
        for node in range(4):
            c = b.counts[t - 1, node]
            level.ingest(node, b.values[t - 1, node, :c],
                         b.strata[t - 1, node, :c])
        level.tick(t)
    scan = TTree(**_kw("scan", backend), device="cpu")
    scan.run_epoch(1, b.values, b.strata, b.counts)
    assert len(scan.results) == len(level.results) == 4
    for a, c in zip(scan.results, level.results):
        for k in ("tick", "sum", "sum_var", "mean", "mean_var", "n_sampled"):
            assert a[k] == c[k], k
        _bits(a["histogram"], c["histogram"])
    assert scan.items_forwarded == level.items_forwarded
    assert (scan.dispatch_count, level.dispatch_count) == (1, 12)


def test_from_spec_and_the_per_tick_api():
    import repro_torch as P

    spec = P.PipelineSpec(
        topology=P.TopologySpec(fanin=(4, 2, 1), capacity=384, num_strata=4),
        sampler=P.SamplerSpec(backend="pallas", fraction=0.1), seed=7)
    tree = TTree.from_spec(spec, engine="level", device="cpu")
    assert (tree.capacities, tree.sample_sizes) == (
        list(P.resolve(spec).capacities), [38, 38, 38])
    tree.set_sample_sizes([1e9, 0.0, 20])
    assert tree.sample_sizes == [38.0, 1.0, 20.0]
    scan = TTree.from_spec(spec, engine="scan", device="cpu")
    with pytest.raises(RuntimeError, match="run_epoch"):
        scan.tick(1)
    with pytest.raises(RuntimeError, match="engine='scan'"):
        tree.run_epoch(1, *(np.zeros((1, 4, 8)),) * 2, np.zeros((1, 4)))
    with pytest.raises(ValueError, match="scan engine"):
        TTree(**_kw("level", "topk"), route_keys=4, device="cpu")
