"""The port's kernels: plain versions against the reference's Pallas
kernels, and the wrappers' dispatch. The reference's kernels run in
Pallas interpret mode, as ``tests/test_fused_tick.py`` runs them. The
ordered ``segment_sum``'s plain version is held bitwise against the
reference's jitted scatter-add (``repro/core/sampling.py``). The CUDA
kernels themselves are held against these plain versions in
``tests/test_torch_cuda_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.fused_level_tick import ops as jft  # noqa: E402
from repro.kernels.stratified_stats import ops as jss  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.fused_level_tick import ops as tft  # noqa: E402
from repro_torch.kernels.fused_level_tick import ref as tft_ref  # noqa: E402
from repro_torch.kernels.segment_sum import ref as tseg_ref  # noqa: E402
from repro_torch.kernels.stratified_stats import ops as tss  # noqa: E402
from repro_torch.kernels.stratified_stats import ref as tss_ref  # noqa: E402

NAMES = ("keep", "values_c", "strata_c", "n_keep", "c", "reservoirs", "y",
         "w_out", "c_out")
SUMS_RTOL = 1e-5  # Σx, Σx²: the Pallas kernel's matmul order vs item order


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def _level(seed, n, cap, x, fill, packed, ties=False):
    rng = np.random.default_rng(seed)
    vals = rng.normal(100, 25, (n, cap)).astype(np.float32)
    vals[:, ::7] *= 400.0
    strata = rng.integers(0, x, (n, cap)).astype(np.int32)
    counts = rng.integers(max(int(0.7 * fill * cap), 0), int(fill * cap) + 1,
                          n)
    if packed:
        valid = np.arange(cap)[None, :] < counts[:, None]
    else:
        valid = np.zeros((n, cap), bool)
        for i in range(n):
            valid[i, rng.choice(cap, counts[i], replace=False)] = True
    if ties:
        u = (rng.integers(0, 53, (n, cap)) / 53.0).astype(np.float32)
    else:
        u = rng.random((n, cap)).astype(np.float32)
    w_in = np.abs(rng.normal(1, 0.2, (n, x))).astype(np.float32)
    c_in = rng.integers(0, 500, (n, x)).astype(np.float32)
    return vals, strata, valid, u, w_in, c_in


# (n, cap, X, budget, fill, packed, allocation, out_capacity, ties)
GRID = [
    (4, 256, 4, 60, 1.0, True, "fair", 60, False),
    (2, 384, 8, 120, 0.6, False, "fair", 48, False),      # OC < keeps
    (3, 128, 3, 7, 0.9, False, "proportional", 128, True),
    (1, 512, 16, 999, 1.0, True, "fair", 512, False),     # saturated
    (2, 300, 5, 400, 0.5, False, "fair", 200, False),     # sat., holes
    (2, 256, 5, 0, 1.0, True, "neyman", 16, False),       # zero budget
    (3, 256, 6, 90, 0.8, True, "neyman", 90, True),
]


@pytest.mark.parametrize(
    "n,cap,x,budget,fill,packed,allocation,out_cap,ties", GRID)
def test_fused_level_tick_plain_matches_pallas(n, cap, x, budget, fill,
                                               packed, allocation, out_cap,
                                               ties):
    arrs = _level(n * cap + x, n, cap, x, fill, packed, ties)
    want = jft.fused_level_tick(*(jnp.asarray(a) for a in arrs),
                                jnp.float32(budget), x, out_cap,
                                allocation=allocation, impl="pallas")
    got = tft.fused_level_tick(*(torch.from_numpy(a) for a in arrs),
                               torch.tensor(float(budget)), x, out_cap,
                               allocation=allocation)
    for name, g, w in zip(NAMES, got, want):
        _bits(g.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("m,x,ties,sat", [(1000, 4, False, False),
                                          (777, 8, True, False),
                                          (600, 4, False, True)])
def test_fused_select_plain_matches_pallas(m, x, ties, sat):
    vals, strata, valid, u, _, _ = _level(m, 1, m, x, 0.9, False, ties)
    c = np.bincount(strata[0][valid[0]], minlength=x).astype(np.float32)
    res = c if sat else np.minimum(c, np.arange(1, x + 1) * 13.0
                                   ).astype(np.float32)
    want = jft.fused_select(jnp.asarray(u[0]), jnp.asarray(strata[0]),
                            jnp.asarray(valid[0]), jnp.asarray(res), x,
                            impl="pallas")
    got = tft.fused_select(*(torch.from_numpy(a[0]) for a in (u, strata,
                                                              valid)),
                           torch.from_numpy(res), x)
    _bits(got.numpy(), np.asarray(want))


# The CUDA kernels' cluster edge cases, at the reference kernel's sizes:
# (n, cap, X, budget, allocation, out_capacity, ties). Caps smaller than
# the cluster of 8 CTAs or not a multiple of it, n_eff = 1 (budget = X).
EDGE_GRID = [
    (3, 5, 2, 2, "fair", 5, False),
    (2, 203, 4, 4, "fair", 64, True),
    (2, 203, 5, 60, "neyman", 50, False),
    (3, 77, 3, 30, "proportional", 20, True),
    (4, 1, 1, 1, "fair", 1, False),
]


def _degenerate(arrs, x):
    """Stratum 0's valid priorities all equal, stratum ``x - 1`` (when
    ``x > 1``) without a valid item."""
    vals, strata, valid, u, w_in, c_in = (a.copy() for a in arrs)
    u[strata == 0] = np.float32(0.37)
    if x > 1:
        valid[strata == x - 1] = False
    return vals, strata, valid, u, w_in, c_in


@pytest.mark.parametrize("n,cap,x,budget,allocation,out_cap,ties",
                         EDGE_GRID)
def test_fused_plain_matches_pallas_on_edge_strata(n, cap, x, budget,
                                                   allocation, out_cap,
                                                   ties):
    arrs = _degenerate(_level(n + cap + x, n, cap, x, 0.9, False, ties), x)
    want = jft.fused_level_tick(*(jnp.asarray(a) for a in arrs),
                                jnp.float32(budget), x, out_cap,
                                allocation=allocation, impl="pallas")
    got = tft.fused_level_tick(*(torch.from_numpy(a) for a in arrs),
                               torch.tensor(float(budget)), x, out_cap,
                               allocation=allocation)
    for name, g, w in zip(NAMES, got, want):
        _bits(g.numpy(), np.asarray(w), name)
    res = np.ones(x, np.float32)
    _, strata, valid, u, _, _ = arrs
    want = jft.fused_select(jnp.asarray(u[0]), jnp.asarray(strata[0]),
                            jnp.asarray(valid[0]), jnp.asarray(res), x,
                            impl="pallas")
    got = tft.fused_select(*(torch.from_numpy(a[0]) for a in (u, strata,
                                                              valid)),
                           torch.from_numpy(res), x)
    _bits(got.numpy(), np.asarray(want))


def test_radix_digits_narrow_as_strata_grow():
    """The kernels' τ search takes 8-bit digits (4 passes) while two
    histogram buffers fit beside the per-stratum arrays in 208 KB of
    shared memory, and narrows to 2 bits (16 passes) at 4,096 strata."""
    bits = [tft.digit_bits(x) for x in range(1, tft.MAX_STRATA + 1)]
    assert bits[0] == bits[100] == 8 and bits[-1] == 2
    assert all(a >= b for a, b in zip(bits, bits[1:]))
    for x, b in zip(range(1, tft.MAX_STRATA + 1), bits):
        assert (5 + 2 * (1 << b)) * x <= 53248
        assert b == 8 or (5 + 2 * (2 << b)) * x > 53248


@pytest.mark.parametrize("m,x", [(2200, 4), (5000, 32), (100, 3)])
def test_stratified_stats_plain_matches_pallas(m, x):
    vals, strata, valid, _, _, _ = _level(m + 1, 1, m, x, 0.8, False)
    want = np.asarray(jss.stratified_stats(
        jnp.asarray(vals[0]), jnp.asarray(strata[0]), jnp.asarray(valid[0]),
        x, impl="pallas"))
    got = tss.stratified_stats(*(torch.from_numpy(a[0]) for a in (
        vals, strata, valid)), x).numpy()
    _bits(got[:, 0], want[:, 0], "count")
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=SUMS_RTOL)
    # The plain version equals the reference's own plain version bitwise.
    _bits(got, np.asarray(jss.stratified_stats(
        jnp.asarray(vals[0]), jnp.asarray(strata[0]), jnp.asarray(valid[0]),
        x, impl="ref")))


@pytest.mark.parametrize("m,x", [(44032, 16), (3000, 4096)])
def test_stratified_stats_plain_matches_reference_oracle(m, x):
    """The ``pallas`` backend's level 0 (4 nodes x 4 strata, flattened) and
    a wide level: the plain version is bitwise the reference's jitted
    oracle (item-order scatters)."""
    vals, strata, valid, _, _, _ = _level(m + x, 1, m, x, 0.8, False)
    got = tss.stratified_stats(*(torch.from_numpy(a[0]) for a in (
        vals, strata, valid)), x).numpy()
    want = np.asarray(jss.stratified_stats(
        jnp.asarray(vals[0]), jnp.asarray(strata[0]), jnp.asarray(valid[0]),
        x, impl="ref"))
    _bits(got, want)


@jax.jit
def _scatter_rows(x, seg, s):
    """The reference's scatter (``repro/core/sampling.py:70``) per row:
    ids outside ``[0, S)`` go to the spare slot ``S``, which is cut off;
    ``s`` is a zero vector of length ``S`` (so jit keys on ``S``)."""
    n = s.shape[0]

    def one(xr, sr):
        ok = (sr >= 0) & (sr < n)
        idx = jnp.where(ok, sr, n)
        return jnp.zeros((n + 1,), jnp.float32).at[idx].add(xr)[:n]

    return jax.vmap(one)(x, seg)


def _order_sensitive(rng, rows, m, x):
    """Mixed magnitudes 1e-3 to 1e6 with alternating signs, so any other
    order of a segment's adds changes its f32 sum; ids in [-2, x + 2)."""
    mag = 10.0 ** rng.uniform(-3, 6, (rows, m))
    sign = np.where(np.arange(m) % 2 == 0, 1.0, -1.0)
    vals = (mag * sign).astype(np.float32)
    ids = rng.integers(-2, x + 2, (rows, m))
    return vals, ids


def _same_sums(got, want):
    """Bitwise, with NaN compared as NaN (payloads and signs of NaN differ
    between the two libraries)."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    _bits(np.where(nan, 0.0, got).astype(np.float32),
          np.where(nan, 0.0, want).astype(np.float32))


@pytest.mark.parametrize("rows,m,x,ids", [
    (1, 2200, 4, np.int32), (4, 11008, 4, np.int32),
    (1, 44032, 16, np.int64), (1, 100003, 1, np.int32)])
def test_segment_sum_plain_matches_reference_scatter(rows, m, x, ids):
    rng = np.random.default_rng(rows * m + x)
    vals, seg = _order_sensitive(rng, rows, m, x)
    seg = seg.astype(ids)
    got = tseg_ref.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg),
                               x)
    want = _scatter_rows(jnp.asarray(vals), jnp.asarray(seg.astype(np.int32)),
                         jnp.zeros((x,), jnp.float32))
    _same_sums(got.numpy(), want)


@pytest.mark.parametrize("case", ["out_of_range", "specials"])
def test_segment_sum_plain_matches_reference_on_edge_values(case):
    rng = np.random.default_rng(17)
    vals, seg = _order_sensitive(rng, 2, 3000, 8)
    if case == "out_of_range":
        seg = np.where(np.arange(3000) % 5 == 0, seg + 1000, seg - 9)
    else:
        # -0.0 alone in segment 0 (its sum is +0.0 from the 0.0 start),
        # an inf in segment 1, +inf and -inf in segment 2 (NaN), a NaN in 3
        seg = np.where(seg < 4, 4, seg)
        seg[:, 0], vals[:, 0] = 0, -0.0
        seg[:, 1], vals[:, 1] = 1, np.inf
        seg[:, 2:4], vals[:, 2:4] = 2, [np.inf, -np.inf]
        seg[:, 5], vals[:, 5] = 3, np.nan
    got = tseg_ref.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg),
                               8)
    want = _scatter_rows(jnp.asarray(vals), jnp.asarray(seg.astype(np.int32)),
                         jnp.zeros((8,), jnp.float32))
    _same_sums(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = dict(LAUNCHES)
    arrs = [torch.from_numpy(a) for a in _level(1, 2, 64, 4, 1.0, True)]
    out = tft.fused_level_tick(*arrs, torch.tensor(10.0), 4, 32)
    ref = tft_ref.fused_level_tick(*arrs, torch.tensor(10.0), 4, 32)
    for name, a, b in zip(NAMES, out, ref):
        _bits(a.numpy(), b.numpy(), name)
    s = tss.stratified_stats(arrs[0][0], arrs[1][0], arrs[2][0], 4)
    _bits(s.numpy(), tss_ref.stratified_stats(arrs[0][0], arrs[1][0],
                                              arrs[2][0], 4).numpy())
    assert LAUNCHES == before


def test_other_devices_raise_instead_of_falling_back():
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tft.fused_level_tick(meta, meta.int(), meta.bool(), meta, meta,
                             meta, 1.0, 4, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tft.fused_select(meta[0], meta[0].int(), meta[0].bool(),
                         torch.ones(4), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tss.stratified_stats(meta[0], meta[0].int(), meta[0].bool(), 4)


def test_build_needs_nvcc_and_keys_libraries_by_source(monkeypatch,
                                                       tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    for name in _build.SOURCES:
        p = _build.library_path(name)
        assert p == _build.library_path(name)
        assert p.parent == _build.BUILD_DIR and name in p.name
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
