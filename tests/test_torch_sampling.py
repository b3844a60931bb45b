"""The port's sampling math against the reference on the same inputs.

Counts, stds and reservoir allocations for all three policies, keep
masks from every backend (exact f32 ties included), WHSamp's weight
update and the root's error answers and histogram edges: bitwise, with
the reference's functions run under ``jax.jit`` as the scan engine runs
them (compiled code contracts some multiply-adds into FMAs, which the
port reproduces).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import error as jerr  # noqa: E402
from repro.core import sampling as jsamp  # noqa: E402
from repro.core import tree as jtree  # noqa: E402
from repro.core import whs as jwhs  # noqa: E402
from repro.core.types import IntervalBatch as JBatch  # noqa: E402
from repro.core.types import StratumMeta as JMeta  # noqa: E402
from repro_torch.core import error as terr  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import sampling as tsamp  # noqa: E402
from repro_torch.core import tree as ttree  # noqa: E402
from repro_torch.core import whs as twhs  # noqa: E402
from repro_torch.core.types import IntervalBatch as TBatch  # noqa: E402
from repro_torch.core.types import StratumMeta as TMeta  # noqa: E402


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                      a.dtype, b.dtype)
    np.testing.assert_array_equal(
        np.ascontiguousarray(a).reshape(-1).view(np.uint8),
        np.ascontiguousarray(b).reshape(-1).view(np.uint8))


def _items(seed, m, x, p_valid=0.8, ties=False, skew=False):
    rng = np.random.default_rng(seed)
    vals = rng.normal(100, 25, m).astype(np.float32)
    vals[::5] *= 300.0
    probs = np.array([0.9] + [0.1 / (x - 1)] * (x - 1)) if skew else None
    strata = rng.choice(x, m, p=probs).astype(np.int32)
    valid = rng.random(m) < p_valid
    if ties:
        u = (rng.integers(0, 61, m) / 61.0).astype(np.float32)
    else:
        u = rng.random(m).astype(np.float32)
    return vals, strata, valid, u


_COUNTS = [
    [0, 0, 0, 0], [5, 0, 3, 9], [1000, 1, 1, 0], [40, 40, 40, 40],
    [3, 700, 2, 9, 0, 55, 1, 1], [1] * 16, [17, 0, 250, 4, 4, 4, 1000, 2],
]


@pytest.mark.parametrize("policy", ["fair", "proportional", "neyman"])
@pytest.mark.parametrize("size", [0.0, 1.0, 3.0, 37.0, 500.0, 5000.0])
def test_allocate_reservoirs_bitwise_and_conserving(policy, size):
    rng = np.random.default_rng(int(size) + len(policy))
    alloc_j = jax.jit(lambda s, c, sd: jsamp.allocate_reservoirs(
        s, c, policy=policy, stds=sd))
    for c in _COUNTS:
        c = np.asarray(c, np.float32)
        stds = (rng.random(c.shape[0]) * 50).astype(np.float32)
        want = alloc_j(jnp.float32(size), jnp.asarray(c), jnp.asarray(stds))
        got = tsamp.allocate_reservoirs(
            torch.tensor(size), torch.from_numpy(c), policy=policy,
            stds=torch.from_numpy(stds))
        _bits(got.numpy(), want)
        # The law: Σ alloc == min(size, Σ c), 0 ≤ alloc ≤ c.
        assert float(got.sum()) == min(size, float(c.sum()))
        assert bool(((got >= 0) & (got <= torch.from_numpy(c))).all())
        if policy != "fair" and size >= (c > 0).sum():
            assert bool((got[torch.from_numpy(c) > 0] >= 1).all())


def test_allocate_reservoirs_batched_rows_equal_single_rows():
    c = torch.tensor([[5., 0., 3., 9.], [40., 40., 40., 40.]])
    both = tsamp.allocate_reservoirs(torch.tensor(10.0), c)
    for i in range(2):
        _bits(both[i].numpy(),
              tsamp.allocate_reservoirs(torch.tensor(10.0), c[i]).numpy())


@pytest.mark.parametrize("m,x", [(100, 4), (2200, 4), (777, 32)])
def test_counts_and_stds_bitwise(m, x):
    vals, strata, valid, _ = _items(m + x, m, x)
    want_c = jax.jit(jsamp.stratum_counts, static_argnums=2)(
        strata, valid, x)
    want_s = jax.jit(jsamp.stratum_stds, static_argnums=3)(
        vals, strata, valid, x)
    t = [torch.from_numpy(a) for a in (vals, strata, valid)]
    _bits(tsamp.stratum_counts(t[1], t[2], x).numpy(), want_c)
    _bits(tsamp.stratum_stds(*t, x).numpy(), want_s)


@pytest.mark.parametrize("backend", ["argsort", "topk", "pallas_fused"])
@pytest.mark.parametrize("ties", [False, True])
def test_select_masks_match_reference(backend, ties):
    m, x = 512, 4
    vals, strata, valid, u = _items(3 + ties, m, x, ties=ties)
    c = np.bincount(strata[valid], minlength=x).astype(np.float32)
    res = np.minimum(c, np.array([5, 40, 0, 200], np.float32))
    jbe = jsamp.get_backend(backend)
    want = jbe.select(None, jnp.asarray(strata), jnp.asarray(valid),
                      jnp.asarray(res), x, priorities=jnp.asarray(u),
                      max_reservoir=200)
    got = tsamp.get_backend(backend).select(
        None, torch.from_numpy(strata), torch.from_numpy(valid),
        torch.from_numpy(res), x, priorities=torch.from_numpy(u),
        max_reservoir=200)
    _bits(got.numpy(), want)
    # Every backend keeps the argsort law.
    _bits(got.numpy(), jsamp.stratified_priority_sample(
        None, jnp.asarray(strata), jnp.asarray(valid), jnp.asarray(res), x,
        priorities=jnp.asarray(u)))


def test_pallas_fused_select_beyond_reference_dense_limit():
    # M·X above the reference's 1 << 22 switch: the reference selects by
    # argsort there; the port keeps calling fused_select, whose law is
    # the same, so the masks agree bitwise.
    m, x = 600_000, 8
    assert m * x > 1 << 22
    vals, strata, valid, u = _items(21, m, x, ties=True)
    c = np.bincount(strata[valid], minlength=x).astype(np.float32)
    res = np.minimum(c, np.arange(1, x + 1, dtype=np.float32) * 5000.0)
    want = jsamp.get_backend("pallas_fused").select(
        None, jnp.asarray(strata), jnp.asarray(valid), jnp.asarray(res), x,
        priorities=jnp.asarray(u))
    got = tsamp.get_backend("pallas_fused").select(
        None, torch.from_numpy(strata), torch.from_numpy(valid),
        torch.from_numpy(res), x, priorities=torch.from_numpy(u))
    _bits(got.numpy(), want)


def test_batched_select_equals_per_row():
    vals, strata, valid, u = _items(8, 3 * 300, 5, ties=True)
    s, v, p = (torch.from_numpy(a).reshape(3, 300) for a in (strata, valid,
                                                             u))
    res = torch.tensor([[3., 9., 0., 50., 7.]] * 3)
    for be in ("argsort", "topk"):
        both = tsamp.get_backend(be).select(None, s, v, res, 5, priorities=p,
                                            max_reservoir=50, batch_hint=3)
        for i in range(3):
            _bits(both[i].numpy(), tsamp.get_backend("argsort").select(
                None, s[i], v[i], res[i], 5, priorities=p[i]).numpy())


@pytest.mark.parametrize("backend", ["argsort", "topk", "pallas_fused"])
@pytest.mark.parametrize("allocation", ["fair", "proportional", "neyman"])
def test_whsamp_matches_reference(backend, allocation):
    m, x = 600, 4
    vals, strata, valid, _ = _items(11, m, x, skew=True)
    rng = np.random.default_rng(5)
    w_in = (rng.random(x) * 3 + 1).astype(np.float32)
    c_in = rng.integers(0, 300, x).astype(np.float32)
    key = jax.random.PRNGKey(77)
    want = jax.jit(lambda: jwhs.whsamp(
        key, JBatch(jnp.asarray(vals), jnp.asarray(strata),
                    jnp.asarray(valid), JMeta(jnp.asarray(w_in),
                                              jnp.asarray(c_in))),
        jnp.float32(90.0), x, allocation=allocation, backend=backend,
        max_reservoir=90))()
    got = twhs.whsamp(
        prng.PRNGKey(77),
        TBatch(*(torch.from_numpy(a) for a in (vals, strata, valid)),
               TMeta(torch.from_numpy(w_in), torch.from_numpy(c_in))),
        torch.tensor(90.0), x, allocation=allocation, backend=backend,
        max_reservoir=90)
    for name in ("selected", "c", "y", "reservoir"):
        _bits(getattr(got, name).numpy(), getattr(want, name))
    _bits(got.meta.count.numpy(), want.meta.count)
    # W·w·C^in/c: the reference's compiler associates this product
    # differently from one program to the next (here (W·calib)·w for
    # proportional and neyman, the written (W·w)·calib elsewhere), so a
    # lone WHSamp call's weight is held to 1 ulp; in the pipelines below
    # it is bitwise.
    np.testing.assert_array_max_ulp(got.meta.weight.numpy(),
                                    np.asarray(want.meta.weight), maxulp=1)


def test_error_answers_bitwise():
    vals, strata, valid, u = _items(21, 900, 4)
    sel = valid & (u < 0.3)
    w = np.array([9.5, 1.0, 33.25, 4.0], np.float32)
    c = np.zeros(4, np.float32)
    js = jax.jit(lambda *a: jerr.approx_sum(*a[:3], JMeta(*a[3:]), 4))
    jm = jax.jit(lambda *a: jerr.approx_mean(*a[:3], JMeta(*a[3:]), 4))
    t = [torch.from_numpy(a) for a in (vals, strata, sel)]
    meta = TMeta(torch.from_numpy(w), torch.from_numpy(c))
    for jf, tf in ((js, terr.approx_sum), (jm, terr.approx_mean)):
        want = jf(vals, strata, sel, w, c)
        got = tf(*t, meta, 4)
        _bits(got.estimate.numpy(), want.estimate)
        _bits(got.variance.numpy(), want.variance)


def test_histogram_edges_match_jnp_linspace():
    """The root's edges: ``jnp.linspace(lo, hi + 1e-6, 65)`` as compiled."""
    edges_j = jax.jit(lambda v, s: jnp.linspace(
        jnp.min(jnp.where(s, v, jnp.inf)),
        jnp.max(jnp.where(s, v, -jnp.inf)) + 1e-6, 65))
    for seed in range(20):
        vals, _, valid, _ = _items(seed, 300, 4)
        _bits(ttree._histogram_edges(torch.from_numpy(vals),
                                     torch.from_numpy(valid), 64).numpy(),
              edges_j(vals, valid))


def test_unported_backend_names_its_roadmap_item():
    """Every backend name of the reference resolves now that the
    ``pallas`` backend (ROADMAP Queue 2 item 6) is ported; an unknown
    name still raises."""
    for name in ("argsort", "topk", "pallas", "pallas_fused"):
        assert tsamp.get_backend(name).name == name
    assert tsamp.get_backend("pallas").flatten_for_level
    with pytest.raises(ValueError, match="unknown sampler backend"):
        tsamp.get_backend("nope")


@pytest.mark.parametrize("out_cap", [40, 400])
def test_compact_sample_matches_reference(out_cap):
    """One node's pack + truncation-corrected (W, C); ``out_cap`` 40 is
    below the keep count, so the weights absorb the extra thinning."""
    vals, strata, valid, u = _items(31, 400, 4)
    w = np.array([2.0, 1.0, 7.5, 3.0], np.float32)
    c = np.array([10.0, 0.0, 5.0, 80.0], np.float32)
    key = jax.random.PRNGKey(3)
    jb = JBatch(jnp.asarray(vals), jnp.asarray(strata), jnp.asarray(valid),
                JMeta(jnp.asarray(w), jnp.asarray(c)))
    want = jax.jit(lambda: jwhs.compact_sample(
        jb, jwhs.whsamp(key, jb, jnp.float32(120.0), 4), out_cap))()
    tb = TBatch(*(torch.from_numpy(a) for a in (vals, strata, valid)),
                TMeta(torch.from_numpy(w), torch.from_numpy(c)))
    got = twhs.compact_sample(
        tb, twhs.whsamp(prng.PRNGKey(3), tb, torch.tensor(120.0), 4),
        out_cap)
    for name in ("value", "stratum", "valid"):
        _bits(getattr(got, name).numpy(), getattr(want, name))
    _bits(got.meta.count.numpy(), want.meta.count)
    np.testing.assert_array_max_ulp(got.meta.weight.numpy(),
                                    np.asarray(want.meta.weight), maxulp=1)


def test_sqrt_rn_is_the_reference_sqrt():
    """``torch.sqrt`` of f32 on the CPU is off by 1 ulp on some inputs;
    ``sqrt_rn`` (which ``stratum_stds`` and the query bounds use) equals
    the reference's compiled ``sqrt`` on all of them."""
    rng = np.random.default_rng(0)
    x = (rng.random(200_000) * 10.0 ** rng.integers(-30, 30, 200_000)
         ).astype(np.float32)
    x[:3] = (0.0, 1.0, 306366.0)
    want = jax.jit(jnp.sqrt)(x)
    _bits(tsamp.sqrt_rn(torch.from_numpy(x)).numpy(), want)
