"""The port's sketches and sketch kernels against the reference, on the CPU.

* The plain kernels (``repro_torch.kernels.sketch_update.ref``) against
  the reference's plain versions, bitwise, and against its Pallas kernels
  in interpret mode: ``quantile_compact`` bitwise, ``cms_update`` within
  ``CMS_RTOL``/``CMS_ATOL`` (the Pallas kernel sums a bucket's weights
  in a one-hot matmul, in another order than item order — the reference's
  own tolerance in ``tests/test_kernels.py``).
* ``quantile_compact`` on intervals the sketch builds, whose blocked
  cumsum can fall by an ulp so that a target lies in two slots: bitwise
  against the jitted reference and the interpret-mode Pallas kernel.
* The reference's cumsum order (``blocked_cumsum``) and top-k tie law.
* Every sketch function against the jitted reference, under capacity
  (lossless) and over it (every level compacts). State and answers are
  bitwise; ``rank_error_bound`` and the heavy-hitter ``total_weight``
  within ``TOTAL_RTOL``: they divide by, or are, an f32 sum over the
  sketch's slots, which the reference's compiled reduction adds in an
  order of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.sketch_update import ref as jref  # noqa: E402
from repro.kernels.sketch_update import sketch_update as jpallas  # noqa: E402
from repro.query import sketches as J  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.sketch_update import ops as tops  # noqa: E402
from repro_torch.kernels.sketch_update import ref as tref  # noqa: E402
from repro_torch.query import sketches as T  # noqa: E402

CMS_RTOL, CMS_ATOL = 1e-5, 1e-3
TOTAL_RTOL = 1e-5


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(np.asarray(a)), np.ascontiguousarray(
        np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape,
                                                       b.shape, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def _same_state(t, j):
    for f in j._fields:
        _bits(getattr(t, f).numpy(), getattr(j, f), f)


def _uniforms(key, n):
    """The port's per-level uniforms for a reference fold key."""
    k = torch.tensor(np.asarray(key).astype(np.int64))
    return prng.uniform(prng.fold_in(k, torch.arange(n)), ())


def _keys_weights(rng, m):
    keys = rng.integers(-2**31, 2**31, m, dtype=np.int64).astype(np.int32)
    w = rng.uniform(0.1, 40.0, m).astype(np.float32)
    w[rng.random(m) < 0.2] = 0.0
    return keys, w


def _intervals(rng, p, c, past_total=0):
    """Value-sorted slots with a shifted-cumsum partition of [0, W) (some
    zero-weight slots), and ``c`` rank targets, ``past_total`` of them at
    or beyond W."""
    v = np.sort(rng.normal(100, 30, p)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, p).astype(np.float32)
    w[rng.random(p) < 0.3] = 0.0
    cumw = np.cumsum(w, dtype=np.float32)
    prev = np.concatenate([[0.0], cumw[:-1]]).astype(np.float32)
    total = float(cumw[-1])
    t = ((np.arange(c) + rng.random()) * total / c).astype(np.float32)
    if past_total:
        t[-past_total:] = np.float32(total) * np.float32(1.0 + 1e-3)
    return v, prev, cumw, t


# ---------------------------------------------------------- plain kernels --
CMS_CASES = [(512, 4, 256), (4096, 2, 1024), (5000, 6, 128), (2200, 4, 1024),
             (100, 1, 1)]


# (M, depth, width, every item on one key)
@pytest.mark.parametrize(
    "m,depth,width,one_key",
    [pytest.param(*c, False, id="-".join(map(str, c))) for c in CMS_CASES]
    + [pytest.param(2200, 4, 1024, True, id="2200-4-1024-one-key"),
       pytest.param(1000, 6, 65536, False, id="1000-6-65536")])
def test_cms_plain_matches_reference(m, depth, width, one_key):
    rng = np.random.default_rng(m + depth)
    keys, w = _keys_weights(rng, m)
    if one_key:
        keys[:] = keys[0]
    got = tref.cms_update(torch.from_numpy(keys), torch.from_numpy(w),
                          depth, width).numpy()
    ku = jnp.asarray(keys).astype(jnp.uint32)
    _bits(got, jref.cms_update(ku, jnp.asarray(w), depth, width))
    _bits(tref.hash_buckets(torch.from_numpy(keys), depth, width)
          .numpy().astype(np.int32), jref.hash_buckets(ku, depth, width))
    if width > 1:
        np.testing.assert_allclose(
            got, np.asarray(jpallas.cms_update(ku, jnp.asarray(w), depth,
                                               width, interpret=True)),
            rtol=CMS_RTOL, atol=CMS_ATOL)


@pytest.mark.parametrize("p,c,past", [(2456, 128, 0), (384, 128, 2),
                                      (640, 64, 1), (5000, 256, 3),
                                      (37, 9, 0)])
def test_quantile_compact_plain_matches_reference(p, c, past):
    rng = np.random.default_rng(p)
    v, prev, cumw, t = _intervals(rng, p, c, past)
    got = tref.quantile_compact(*(torch.from_numpy(a)
                                  for a in (v, prev, cumw, t))).numpy()
    _bits(got, jref.quantile_compact(v, prev, cumw, t))
    _bits(got, jpallas.quantile_compact(v, prev, cumw, t, interpret=True))
    if past:
        assert (got[-past:] == 0.0).all()


def _sketch_intervals(seed, p, c):
    """Intervals as the sketch builds them: ``cumw`` by the reference's
    blocked scan (which can fall by an ulp at a block boundary),
    ``cumw_prev`` shifted by one, weights with zeros. Targets sit in
    every descent (a target there lies in two slots) and on a lone
    ``-0.0`` value; the rest are equi-spaced, the last at the total (no
    slot). Returns the arrays and each target's number of hits."""
    rng = np.random.default_rng(seed)
    v = np.sort(rng.normal(0, 30, p)).astype(np.float32)
    w = (rng.uniform(0.5, 3.0, p) * rng.choice([1.0, 7.0, 1000.0], p)
         ).astype(np.float32)
    w[rng.random(p) < 0.3] = 0.0
    cumw = T.blocked_cumsum(torch.from_numpy(w)).numpy()
    _bits(cumw, jax.jit(jnp.cumsum)(w), "cumw")
    prev = np.concatenate([[0.0], cumw[:-1]]).astype(np.float32)
    live = np.nonzero(w > 0)[0]
    z = live[np.argmin(np.abs(v[live]))]
    v[z] = -0.0
    dips = cumw[np.nonzero(cumw[1:] < cumw[:-1])[0] + 1][: c // 2]
    n_eq = c - len(dips) - 2
    t = np.concatenate([
        ((np.arange(n_eq) + rng.random()) * cumw[-1] / n_eq),
        dips, [(prev[z] + cumw[z]) / 2, cumw[-1]]]).astype(np.float32)
    hits = ((prev[:, None] <= t[None, :]) & (t[None, :] < cumw[:, None])
            ).sum(0)
    return (v, prev, cumw, t), hits


@pytest.mark.parametrize("p,c", [(1025, 64), (2456, 128), (5000, 300),
                                 (65536, 300)])
def test_quantile_compact_plain_on_sketch_intervals(p, c):
    """Where the blocked cumsum falls, a target lies in two slots: the
    port's plain version, the jitted reference and the interpret-mode
    Pallas kernel all add both, bitwise; a lone ``-0.0`` gives ``+0.0``."""
    arrs, hits = _sketch_intervals(p + c, p, c)
    assert (hits == 2).any() and hits[-2] == 1 and hits[-1] == 0
    got = tref.quantile_compact(*(torch.from_numpy(a) for a in arrs)).numpy()
    _bits(got, jax.jit(jref.quantile_compact)(*arrs))
    _bits(got, jpallas.quantile_compact(*arrs, interpret=True))
    v = arrs[0]
    two = np.nonzero(hits == 2)[0]
    assert not np.array_equal(got[two], np.zeros_like(got[two]))
    assert got[-2] == 0.0 and not np.signbit(got[-2]) and np.signbit(
        v[v == 0.0]).any()


def test_wrappers_on_cpu_use_the_plain_version_without_a_launch():
    rng = np.random.default_rng(3)
    keys, w = _keys_weights(rng, 300)
    before = dict(LAUNCHES)
    k, wt = torch.from_numpy(keys), torch.from_numpy(w)
    _bits(tops.cms_update(k, wt, 4, 64).numpy(),
          tref.cms_update(k, wt, 4, 64).numpy())
    args = [torch.from_numpy(a) for a in _intervals(rng, 200, 16)]
    _bits(tops.quantile_compact(*args).numpy(),
          tref.quantile_compact(*args).numpy())
    assert LAUNCHES == before
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.cms_update(meta.int(), meta, 4, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.quantile_compact(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="power of 2"):
        tops.cms_update(k, wt, 4, 48)
    with pytest.raises(ValueError, match="depth"):
        tops.cms_update(k, wt, 7, 64)


# ---------------------------------------------------------------- helpers --
@pytest.mark.parametrize("n", [7, 100, 1500, 2476])
def test_blocked_cumsum_is_the_reference_cumsum(n):
    rng = np.random.default_rng(n)
    x = (rng.random(n) * rng.integers(1, 1000, n)).astype(np.float32)
    x[rng.random(n) < 0.3] = 0.0
    want = jax.jit(jnp.cumsum)(x)
    _bits(T.blocked_cumsum(torch.from_numpy(x)).numpy(), want)
    # batched over a leading axis, as a slot dimension would be
    both = np.stack([x, x[::-1]])
    _bits(T.blocked_cumsum(torch.from_numpy(both)).numpy(),
          jax.jit(jax.vmap(jnp.cumsum))(both))
    # and it is not the left-to-right sum
    if n >= 100:
        assert not np.array_equal(np.cumsum(x, dtype=np.float32),
                                  np.asarray(want))


def test_topk_takes_the_lowest_index_first_among_ties():
    x = np.array([3, 1, 3, 3, -1, -1], np.float32)
    vals, idx = T.topk_lowest_index(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    _bits(vals.numpy(), jv)
    assert idx.tolist() == np.asarray(ji).tolist() == [0, 2, 3, 1]


def test_hh_item_key_and_static_bounds():
    v = np.array([0.5, 1.5, 2.5, -0.5, 41.49, 41.5, -7.5], np.float32)
    _bits(T.hh_item_key(torch.from_numpy(v)).numpy(), J.hh_item_key(v))
    for cap in (8, 32, 64, 256):
        assert T.kll_schedule(cap) == J.kll_schedule(cap)
        assert T.quantile_rank_error_bound(cap) == \
            J.quantile_rank_error_bound(cap)
    tw = torch.tensor(123.5)
    assert float(T.hh_error_bound(256, tw)) == float(
        J.hh_error_bound(256, jnp.float32(123.5)))


# --------------------------------------------------------------- quantile --
def _batch(rng, m, live=0.7):
    v = np.round(rng.normal(100, 30, m), 1).astype(np.float32)
    w = ((rng.random(m) < live) * rng.uniform(1, 5, m)).astype(np.float32)
    return v, w


@pytest.mark.parametrize("cap,m,folds", [(64, 20, 3),     # lossless
                                         (64, 300, 40),   # every level
                                         (16, 90, 8),     # 2 levels
                                         (8, 30, 5)])     # 1 level
def test_quantile_update_and_query_match_reference(cap, m, folds):
    rng = np.random.default_rng(cap * 1000 + m)
    base = jax.random.PRNGKey(11)
    sj, st = J.quantile_init(cap), T.quantile_init(cap)
    qs = np.array([0.0, 0.1, 0.5, 0.9, 0.99, 1.0], np.float32)
    live = [0] * st.levels          # the schedule's bookkeeping, per level
    per_level = [0] * st.levels     # compactions per level
    for i in range(folds):
        v, w = _batch(rng, m)
        add = int((w > 0).sum())
        for h in range(st.levels):
            live[h] += add
            if live[h] <= cap:
                break
            per_level[h] += 1
            if h == st.levels - 1:
                live[h] = cap
                break
            live[h], add = 0, cap // 2
        k = jax.random.fold_in(base, i)
        sj = J.quantile_update(k, sj, v, w)
        st = T.quantile_update(_uniforms(k, st.levels), st,
                               torch.from_numpy(v), torch.from_numpy(w))
        _same_state(st, sj)
        _bits(T.quantile_query(st, torch.from_numpy(qs)).numpy(),
              J.quantile_query(sj, qs))
        np.testing.assert_allclose(float(st.rank_error_bound),
                                   float(sj.rank_error_bound),
                                   rtol=TOTAL_RTOL)
    assert float(st.compactions) == sum(per_level)
    if m * folds <= cap:
        assert float(st.rank_error_bound) == 0.0
    else:
        assert min(per_level) >= 1, per_level    # every level compacted


def test_quantile_merges_match_reference():
    rng = np.random.default_rng(5)
    sks_j, sks_t = [], []
    for n in range(3):
        sj, st = J.quantile_init(64), T.quantile_init(64)
        for i in range(12):
            v, w = _batch(rng, 150)
            k = jax.random.fold_in(jax.random.PRNGKey(n), i)
            sj = J.quantile_update(k, sj, v, w)
            st = T.quantile_update(_uniforms(k, 4), st, torch.from_numpy(v),
                                   torch.from_numpy(w))
        sks_j.append(sj)
        sks_t.append(st)
    km = jax.random.PRNGKey(99)
    u = _uniforms(km, 4)
    # same schedule: level-wise
    _same_state(T.quantile_merge(u, sks_t[0], sks_t[1]),
                J.quantile_merge(km, sks_j[0], sks_j[1]))
    # another schedule: flattened into level 0
    sj2, st2 = J.quantile_init(16), T.quantile_init(16)
    v, w = _batch(rng, 40)
    sj2 = J.quantile_update(km, sj2, v, w)
    st2 = T.quantile_update(_uniforms(km, 2), st2, torch.from_numpy(v),
                            torch.from_numpy(w))
    _same_state(T.quantile_merge(u, sks_t[0], st2),
                J.quantile_merge(km, sks_j[0], sj2))
    # stacked, as folded
    stj = jax.tree.map(lambda *a: jnp.stack(a), *sks_j)
    stt = T.QuantileSketch(*(torch.stack(a) for a in zip(*sks_t)))
    _same_state(T.quantile_merge_stacked(u, stt),
                J.quantile_merge_stacked(km, stj))
    # stacked full summaries: every level receives 3·C live points and
    # compacts, the top one in place
    value = np.sort(rng.normal(100, 30, (3, 4, 64)), -1).astype(np.float32)
    weight = rng.uniform(1, 9, (3, 4, 64)).astype(np.float32)
    comp = np.array([2, 0, 5], np.float32)
    err = rng.uniform(0, 50, 3).astype(np.float32)
    mj = J.quantile_merge_stacked(km, J.QuantileSketch(value, weight, comp,
                                                       err))
    mt = T.quantile_merge_stacked(u, T.QuantileSketch(*(
        torch.from_numpy(a) for a in (value, weight, comp, err))))
    _same_state(mt, mj)
    assert float(mt.compactions) == 7.0 + 4


def test_windowed_quantile_matches_reference():
    rng = np.random.default_rng(8)
    rj, rt = J.windowed_quantile_init(32, 3), T.windowed_quantile_init(32, 3)
    upd = jax.jit(J.windowed_quantile_update)
    qs = np.array([0.5, 0.99], np.float32)
    for i in range(7):
        v, w = _batch(rng, 20 if i < 2 else 200)   # lossless, then over
        k = jax.random.fold_in(jax.random.PRNGKey(4), i)
        km = jax.random.fold_in(k, 0x574D)
        rj = upd(k, rj, v, w)
        rt = T.windowed_quantile_update(_uniforms(k, 2), rt,
                                        torch.from_numpy(v),
                                        torch.from_numpy(w))
        _same_state(rt, rj)
        mj = J.windowed_quantile_merged(km, rj)
        mt = T.windowed_quantile_merged(_uniforms(km, 2), rt)
        _same_state(mt, mj)
        _bits(T.quantile_query(mt, torch.from_numpy(qs)).numpy(),
              J.quantile_query(mj, qs))
        np.testing.assert_allclose(float(mt.rank_error_bound),
                                   float(mj.rank_error_bound),
                                   rtol=TOTAL_RTOL)
    assert int(rt.head) == 7 % 3


# ---------------------------------------------------------- heavy hitters --
def _hh_batch(rng, m):
    v = rng.normal(50, 10, m).astype(np.float32)
    v[: m // 4] = 42.0                       # one dominant key
    w = ((rng.random(m) < 0.6) * rng.choice([2.5, 7.25], m)).astype(
        np.float32)                         # equal HT weights: ties
    return v, w


@pytest.mark.parametrize("decay", [None, 0.8])
def test_hh_updates_match_reference(decay):
    rng = np.random.default_rng(21)
    sj, st = J.hh_init(8, 256, 4), T.hh_init(8, 256, 4)
    if decay is None:
        fj = jax.jit(J.hh_update)
        ft = T.hh_update
    else:
        fj = jax.jit(lambda s, k, w: J.hh_decayed_update(s, k, w, decay))
        ft = lambda s, k, w: T.hh_decayed_update(s, k, w, decay)  # noqa
    for _ in range(6):
        v, w = _hh_batch(rng, 400)
        sj = fj(sj, J.hh_item_key(v), w)
        st = ft(st, T.hh_item_key(torch.from_numpy(v)), torch.from_numpy(w))
        _same_state(st, sj)
        np.testing.assert_allclose(float(st.total_weight),
                                   float(sj.total_weight), rtol=TOTAL_RTOL)
    assert int(st.key[0]) == 42
    keys = torch.tensor([42, 7, 2**31 - 1], dtype=torch.int32)
    _bits(T.hh_point_estimate(st.counts, keys).numpy(),
          J.hh_point_estimate(sj, keys.numpy()))


def test_hh_merges_match_reference():
    rng = np.random.default_rng(2)
    pairs = []
    for _ in range(3):
        sj, st = J.hh_init(4, 128, 3), T.hh_init(4, 128, 3)
        v, w = _hh_batch(rng, 300)
        sj = jax.jit(J.hh_update)(sj, J.hh_item_key(v), w)
        st = T.hh_update(st, T.hh_item_key(torch.from_numpy(v)),
                         torch.from_numpy(w))
        pairs.append((sj, st))
    _same_state(T.hh_merge(pairs[0][1], pairs[1][1]),
                jax.jit(J.hh_merge)(pairs[0][0], pairs[1][0]))
    stj = jax.tree.map(lambda *a: jnp.stack(a), *(p[0] for p in pairs))
    stt = T.HeavyHitterSketch(*(torch.stack(a) for a in
                                zip(*(p[1] for p in pairs))))
    _same_state(T.hh_merge_stacked(stt), jax.jit(J.hh_merge_stacked)(stj))
