"""The port's checkpoints (``repro_torch.checkpoint``, ``api.save_state`` /
``restore_state``) on the CPU, and against the reference's format.

The manager's own laws (round trip, keep-N with a crashed ``.tmp``
ignored, the asynchronous writer, the re-mesh on load), both ``SpecError``s of
``restore_state``, and the format across packages: the port flattens a
``PipelineState`` in the order ``jax.tree_util.tree_flatten`` gives the
reference's, so a checkpoint written by the reference restores into the
port and resumes bitwise against the reference's own resume, and the
other way round. Resumed answers are bitwise but for the sketches'
bounds, a sum over the sketch's weights in another order, held to
``TOTAL_RTOL`` (1e-5).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.checkpoint import manager as jckpt  # noqa: E402
from repro.query.registry import QueryRegistry as JQ  # noqa: E402
import repro_torch as tapi  # noqa: E402
from repro_torch import api as tapi_mod  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.query import QueryRegistry as TQ  # noqa: E402

TOTAL_RTOL = 1e-5
SKETCH_KINDS = ("quantile", "windowed_quantile", "heavy_hitters",
                "decayed_heavy_hitters")


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def _tenants(Q):
    return ((Q().register_sum().register_count().register_mean()
             .register_quantile("q", (0.5, 0.9), capacity=64)
             .as_tenant("alpha")),
            (Q().register_histogram("h", 0.0, 100.0, 8)
             .register_windowed_quantile("wq", (0.5,), capacity=32,
                                         window=3)
             .register_decayed_heavy_hitters("dhh", k=4, width=128,
                                             decay=0.8)
             .as_tenant("beta")))


def _spec(api, Q, seed=2):
    return api.PipelineSpec(
        topology=api.TopologySpec(fanin=(4, 2, 1), capacity=512,
                                  num_strata=3),
        sampler=api.SamplerSpec(mode="whs", backend="topk", fraction=0.2),
        tenants=_tenants(Q), telemetry=api.TelemetrySpec(enabled=True),
        seed=seed)


def _ingest(epochs=2, ticks=3, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(epochs):
        vals = rng.normal(50, 9, (ticks, 4, 400)).astype(np.float32)
        strs = rng.integers(0, 3, (ticks, 4, 400)).astype(np.int32)
        counts = rng.integers(100, 400, (ticks, 4)).astype(np.int32)
        out.append((vals, strs, counts))
    return out


def _tpipe(seed=2):
    return tapi.compile(_spec(tapi, TQ, seed), device="cpu")


def _jpipe(seed=2):
    return japi.compile(_spec(japi, JQ, seed))


def _same_answers(pipe, twa, jwa):
    cols = [c for o, w, kind in pipe.query_layout().values()
            if kind in SKETCH_KINDS for c in range(o, o + w)]
    _bits(twa.answers.numpy(), np.asarray(jwa.answers), "answers")
    tb, jb = twa.bounds.numpy(), np.asarray(jwa.bounds)
    exact = np.setdiff1d(np.arange(jb.shape[-1]), cols)
    _bits(tb[:, exact], jb[:, exact], "bounds")
    np.testing.assert_allclose(tb[:, cols], jb[:, cols], rtol=TOTAL_RTOL)
    for f in ("tick", "ok", "sum", "sum_var", "mean", "mean_var",
              "n_sampled", "histogram", "n_forwarded"):
        _bits(getattr(twa, f).numpy(), np.asarray(getattr(jwa, f)), f)


# ---------------------------------------------------------- the manager --
def test_roundtrip_keeps_structure_dtypes_and_bits(tmp_path):
    tree = {"b": (torch.arange(6, dtype=torch.int32).reshape(2, 3), None,
                  ()),
            "a": [torch.rand(4), np.ones((2,), np.float64)],
            "c": torch.tensor([True, False])}
    ckpt.save(tmp_path, 7, tree, meta={"note": "x"})
    assert ckpt.latest_step(tmp_path) == 7
    man = ckpt.read_manifest(tmp_path, 7)
    assert man["num_leaves"] == 4 and man["meta"] == {"note": "x"}
    # dicts by sorted key, then in order; () and None give no leaf
    assert [l["shape"] for l in man["leaves"]] == [[4], [2], [2, 3], [2]]
    out, meta = ckpt.restore(tmp_path, 7, tree)
    assert meta == {"note": "x"} and list(out) == ["b", "a", "c"]
    assert out["b"][1] is None and out["b"][2] == ()
    for x, y in zip(ckpt._flatten(tree), ckpt._flatten(out)):
        assert type(x) is type(y)
        _bits(np.asarray(x), np.asarray(y))
    with pytest.raises(ValueError, match="leaf count"):
        ckpt.restore(tmp_path, 7, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, 7, dict(tree, c=torch.zeros(3, dtype=bool)))
    # the re-mesh on load: rank 1 of 2 takes row 1 of a per-rank leaf
    # (the reference's [N, ...] layout), the replicated leaves whole
    from repro_torch.launch.mesh import DataMesh
    from repro_torch.launch.sharding import (PER_RANK, REPLICATED,
                                             RankShardings)

    mesh = DataMesh(rank=1, size=2, device="cpu", backend="gloo")
    rows = dict(tree, b=(torch.zeros((1, 3), dtype=torch.int32), None, ()))
    place = {"b": (PER_RANK, None, ()), "a": [REPLICATED, REPLICATED],
             "c": REPLICATED}
    out, _ = ckpt.restore(tmp_path, 7, rows,
                          shardings=RankShardings(mesh, place))
    _bits(out["b"][0].numpy(), np.asarray([[3, 4, 5]], np.int32))
    _bits(out["c"].numpy(), tree["c"].numpy())
    with pytest.raises(ValueError, match="rows"):
        ckpt.restore(tmp_path, 7, rows, shardings=RankShardings(
            DataMesh(rank=0, size=4, device="cpu", backend="gloo"), place))


def test_keep_n_and_tmp_ignored(tmp_path):
    tree = {"w": torch.zeros(3)}
    for step in (1, 2, 3, 4):
        ckpt.save(tmp_path, step, tree, keep_n=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000003", "step_000000004"]
    (tmp_path / "step_000000009.tmp").mkdir()   # a crashed write
    assert ckpt.latest_step(tmp_path) == 4
    assert ckpt.latest_step(tmp_path / "none") is None


def test_async_checkpointer_writes_a_copy(tmp_path):
    w = torch.arange(5, dtype=torch.float32)
    saver = ckpt.AsyncCheckpointer(tmp_path, keep_n=2)
    saver.save(1, {"w": w}, meta={"s": 1})
    w += 100.0     # the caller goes on using its buffers
    saver.save(2, {"w": w})
    saver.wait()
    assert ckpt.latest_step(tmp_path) == 2
    out, meta = ckpt.restore(tmp_path, 1, {"w": torch.zeros(5)})
    assert meta == {"s": 1}
    _bits(out["w"].numpy(), np.arange(5, dtype=np.float32))


# ------------------------------------------------------------- the API --
def test_resume_is_bitwise_and_spec_errors(tmp_path):
    e1, e2 = _ingest()
    pipe = _tpipe()
    st, _ = pipe.run_epoch(pipe.init(), pipe.default_key, *e1)
    tapi_mod.save_state(tmp_path, 1, st, pipeline=pipe)
    st, want = pipe.run_epoch(st, pipe.default_key, *e2)

    fresh = _tpipe()
    restored, meta = tapi_mod.restore_state(tmp_path, fresh)
    assert meta["pipeline_spec"] == fresh.spec.to_dict()
    assert meta["slots"] == fresh.plan.slot_manifest()
    _, got = fresh.run_epoch(restored, fresh.default_key, *e2)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(tapi.SpecError, match="different PipelineSpec"):
        tapi_mod.restore_state(tmp_path, _tpipe(seed=3))
    churned = _tpipe()
    churned, _ = churned.admit(churned.init(),
                               TQ().register_sum().as_tenant("gamma"))
    churned, _ = churned.retire(churned.init(), "gamma")
    with pytest.raises(tapi.SpecError, match="tenant-slot configuration"):
        tapi_mod.restore_state(tmp_path, churned)
    with pytest.raises(tapi.SpecError, match="no pipeline checkpoints"):
        tapi_mod.restore_state(tmp_path / "empty", fresh)


def test_leaf_order_is_the_references():
    e1, _ = _ingest()
    tp, jp = _tpipe(), _jpipe()
    tst, _ = tp.run_epoch(tp.init(), tp.default_key, *e1)
    jst, _ = jp.run_epoch(jp.init(), jp.default_key, *e1)
    t_leaves = ckpt._flatten(tst)
    j_leaves = jax.tree_util.tree_flatten(jst)[0]
    assert len(t_leaves) == len(j_leaves) > 40
    for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, i


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_checkpoint_crosses_packages_and_resumes_bitwise(tmp_path, writer):
    e1, e2 = _ingest()
    tp, jp = _tpipe(), _jpipe()
    tst, _ = tp.run_epoch(tp.init(), tp.default_key, *e1)
    jst, _ = jp.run_epoch(jp.init(), jp.default_key, *e1)
    if writer == "reference":
        japi.save_state(tmp_path, 4, jst, pipeline=jp)
        jst, jwa = jp.run_epoch(jst, jp.default_key, *e2)
        fresh = _tpipe()
        restored, meta = tapi_mod.restore_state(tmp_path, fresh)
        _, twa = fresh.run_epoch(restored, fresh.default_key, *e2)
    else:
        tapi_mod.save_state(tmp_path, 4, tst, pipeline=tp)
        tst, twa = tp.run_epoch(tst, tp.default_key, *e2)
        fresh = _jpipe()
        restored, meta = japi.restore_state(tmp_path, fresh)
        _, jwa = fresh.run_epoch(restored, fresh.default_key, *e2)
    man = json.loads((tmp_path / "step_000000004" /
                      "manifest.json").read_text())
    assert man["num_leaves"] == len(man["leaves"]) > 40
    assert meta["slots"] == tp.plan.slot_manifest()
    _same_answers(tp, twa, jwa)
