"""The port's linear queries and backend registry against the reference's,
on the CPU.

``core.queries`` ``weighted_sum``, ``weighted_mean``, ``weighted_count``
and ``map_query``, and ``core.types.QueryResult.bound``, take the same
seeded weighted samples in both packages and are compared bitwise with
the jitted reference (XLA contracts multiply-adds into FMAs only under
``jit``, and the port writes those contractions). ``register_backend``
makes a backend resolvable by name, as the reference's does.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import queries as jq  # noqa: E402
from repro.core import sampling as jsamp  # noqa: E402
from repro.core import types as jt  # noqa: E402
from repro_torch.core import queries as tq  # noqa: E402
from repro_torch.core import sampling as tsamp  # noqa: E402
from repro_torch.core import types as tt  # noqa: E402

X = 4


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def _sample(seed, m=700):
    rng = np.random.default_rng(seed)
    vals = rng.normal(100, 25, m).astype(np.float32)
    vals[::7] *= 300.0
    strata = rng.integers(0, X, m).astype(np.int32)
    valid = rng.random(m) < 0.85
    sel = valid & (rng.random(m) < 0.3)
    w = np.abs(rng.normal(5, 3, X)).astype(np.float32) + 1.0
    c = rng.integers(0, 200, X).astype(np.float32)
    y = rng.integers(0, 50, X).astype(np.float32)
    return vals, strata, valid, sel, w, c, y


def _both(mod, vals, strata, valid, sel, w, c, y):
    if mod is tt:
        vals, strata, valid, sel, w, c, y = (
            torch.from_numpy(a) for a in (vals, strata, valid, sel, w, c, y))
    meta = mod.StratumMeta(w, c)
    batch = mod.IntervalBatch(vals, strata, valid, meta)
    return batch, mod.SampleResult(sel, meta, c, y, sel)


@pytest.mark.parametrize("seed", range(3))
def test_linear_queries_are_the_reference(seed):
    arrs = _sample(seed)

    def run(fn_name, f=None):
        def ref(*a):
            batch, res = _both(jt, *a)
            fn = getattr(jq, fn_name)
            q = fn(f[0], batch, res, X) if f else fn(batch, res, X)
            return q.estimate, q.variance, q.bound(), q.bound(3.0)
        want = jax.jit(ref)(*arrs)
        batch, res = _both(tt, *arrs)
        fn = getattr(tq, fn_name)
        q = fn(f[1], batch, res, X) if f else fn(batch, res, X)
        got = (q.estimate, q.variance, q.bound(), q.bound(3.0))
        for name, g, w_ in zip(("estimate", "variance", "bound2", "bound3"),
                               got, want):
            _bits(g.numpy(), np.asarray(w_), f"{fn_name} {name}")

    for name in ("weighted_sum", "weighted_mean", "weighted_count"):
        run(name)
    run("map_query", (lambda v: v * v, lambda v: v * v))
    run("map_query", (lambda v: (v > 100.0).astype(np.float32),
                      lambda v: (v > 100.0).float()))


def test_register_backend_resolves_by_name():
    class Named(tsamp.TopKBackend):
        name = "topk_copy"

    class JNamed(jsamp.TopKBackend):
        name = "topk_copy"

    try:
        for mod, cls in ((tsamp, Named), (jsamp, JNamed)):
            backend = cls()
            mod.register_backend(backend)
            assert mod.get_backend("topk_copy") is backend
            assert mod.get_backend(backend) is backend
    finally:
        tsamp._BACKENDS.pop("topk_copy", None)
        jsamp._BACKENDS.pop("topk_copy", None)
    assert sorted(tsamp._BACKENDS) == sorted(jsamp._BACKENDS)
    with pytest.raises(ValueError, match="registered"):
        tsamp.get_backend("topk_copy")
