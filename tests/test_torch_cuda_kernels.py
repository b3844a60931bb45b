"""The port's CUDA kernels against their plain PyTorch versions.

Every test needs a CUDA device: each carries the ``cuda`` marker and
skips without one. The module imports neither JAX nor the reference, so
it also runs on a machine that has only the port:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Masks, counts, reservoirs, weights, compacted buffers and ``n_keep``
are compared bitwise; ``stratified_stats``' Σx and Σx² within
``SUMS_RTOL`` (a fixed-order block reduction against item order).
``cms_update`` and ``quantile_compact`` are compared bitwise, and the
sketches that call them (``hh_update``, ``quantile_update``) launch them
as often as their design says. ``sample_mask`` and the ordered
``segment_sum`` are compared bitwise too (the latter against the CPU's
``index_add_``, on sums whose value depends on their order);
``sample_mask`` also on the vector path's tail, on views at storage
offsets that force its scalar path, on NaN priorities and -0.0 against
τ = +0.0, at 1 to 6,144 strata, and one call is one launch. The
``pallas_fused`` kernels are held bitwise above 32 strata per node too,
at every change of the radix digit's width up to 4,096 strata, on caps
that the cluster of CTAs does not divide or that are smaller than it, on
strata whose priorities are all equal or that hold no valid item, and at
``n_eff = 1``; the neyman moments at ``skew.peak-f10``'s two launches
(stratum sums past 2^24), at 600 strata and over valid items with holes.
The neyman launches of ``taxi-zones.peak-f10`` (263 zones, Zipf shares)
are held bitwise at their full shapes too.
``quantile_compact`` is held on intervals the sketch builds
(``blocked_cumsum``), where a target can fall in two slots.
``flash_attention`` is held to its plain version within
``FLASH_F32_TOL`` in f32 and one bf16 ulp in bf16 (see
``assert_flash_close``), the bf16 (tensor-core) kernel over sequence
lengths 16 to 2,048, head dims 32, 64 and 128 and GQA ratios 1, 3 and 4,
with its GQA head mapping in both dtypes, its launch count in the model's
prefill, and a build failure that raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import sampling as tsamp  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.fused_level_tick import ops as tft  # noqa: E402
from repro_torch.kernels.fused_level_tick import ref as tft_ref  # noqa: E402
from repro_torch.kernels.stratified_stats import ops as tss  # noqa: E402
from repro_torch.kernels.stratified_stats import ref as tss_ref  # noqa: E402
from repro_torch.kernels.sketch_update import ops as tsk  # noqa: E402
from repro_torch.kernels.sketch_update import ref as tsk_ref  # noqa: E402
from repro_torch.kernels.sample_mask import ops as tsm  # noqa: E402
from repro_torch.kernels.sample_mask import ref as tsm_ref  # noqa: E402
from repro_torch.kernels.segment_sum import ops as tseg  # noqa: E402
from repro_torch.kernels.segment_sum import ref as tseg_ref  # noqa: E402
from repro_torch.query import sketches as tsketch  # noqa: E402

NAMES = ("keep", "values_c", "strata_c", "n_keep", "c", "reservoirs", "y",
         "w_out", "c_out")
SUMS_RTOL = 1e-5


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


# approxiot-skew's stream (bench/configs/approxiot-skew.json): the shares
# and Poisson means of its four sub-streams.
SKEW_SHARES = (0.8, 0.1989, 0.001, 0.0001)
SKEW_LAMBDAS = (10.0, 100.0, 1e3, 1e7)


def _level(seed, n, cap, x, fill, packed, ties=False, skew=False):
    """A stacked level on the CPU. ``skew``: strata and values by the
    skewed stream's law (x = 4), each node filled to within 1% of
    ``fill``, so that stratum 0's sums pass 2^24 at the cell's sizes;
    else normal values over x uniform strata, 70-100% of ``fill``."""
    rng = np.random.default_rng(seed)
    if skew:
        strata = rng.choice(len(SKEW_SHARES), (n, cap),
                            p=SKEW_SHARES).astype(np.int32)
        vals = rng.poisson(np.asarray(SKEW_LAMBDAS)[strata]).astype(
            np.float32)
        low = int(0.99 * fill * cap)
    else:
        vals = rng.normal(100, 25, (n, cap)).astype(np.float32)
        vals[:, ::7] *= 400.0
        strata = rng.integers(0, x, (n, cap)).astype(np.int32)
        low = max(int(0.7 * fill * cap), 0)
    counts = rng.integers(low, int(fill * cap) + 1, n)
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
    (4, 11008, 4, 1100, 0.73, True, "fair", 1100, False),  # testbed L0
    (2, 2200, 4, 1100, 1.0, True, "fair", 1100, False),    # testbed L1
    (2, 2200, 4, 2200, 1.0, True, "fair", 2200, False),    # saturated
    (2, 2200, 4, 5000, 0.6, False, "fair", 1500, False),   # sat., holes
    (3, 4096, 8, 900, 0.9, True, "fair", 500, False),      # OC < keeps
    (2, 4096, 4, 700, 0.8, False, "fair", 700, True),      # exact ties
    (3, 4096, 6, 1000, 0.9, True, "proportional", 1000, False),
    (3, 4096, 6, 1000, 0.9, False, "neyman", 1000, False),
    (3, 8192, 32, 1500, 0.95, False, "neyman", 1200, True),  # the limit
    (2, 1024, 4, 0, 1.0, True, "fair", 64, False),         # zero budget
    # caps that the cluster of 8 CTAs does not divide, or smaller than it
    (3, 2203, 4, 700, 0.9, False, "fair", 600, True),
    (2, 1001, 6, 300, 1.0, True, "proportional", 300, False),
    (3, 5, 2, 2, 1.0, True, "fair", 5, False),
    (2, 7, 3, 4, 0.9, False, "neyman", 3, True),
    (4, 1, 1, 1, 1.0, True, "fair", 1, False),
]
# (n, cap, X, budget, fill, packed, allocation, out_capacity, ties, skew):
# skew.peak-f10's neyman launches, whose moments are the longest item-order
# chains the kernel sees.
SKEW_GRID = [
    (4, 2700032, 4, 270003, 0.74, True, "neyman", 270003, False, True),  # L0
    (2, 540006, 4, 54000, 1.0, True, "neyman", 54000, False, True),      # L1
    # more strata than a CTA has threads, about 1M valid items
    (1, 1200000, 600, 100000, 0.9, True, "neyman", 100000, False, False),
    # valid items not a prefix: the walk to the last one skips holes
    (2, 540006, 4, 54000, 0.9, False, "neyman", 54000, False, True),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,cap,x,budget,fill,packed,allocation,out_cap,ties,skew",
    [(*row, False) for row in GRID] + SKEW_GRID,
    ids=["-".join(map(str, row)) for row in GRID + SKEW_GRID])
def test_fused_level_tick_kernel_matches_plain(cuda_device, n, cap, x,
                                               budget, fill, packed,
                                               allocation, out_cap, ties,
                                               skew):
    arrs = [torch.from_numpy(a) for a in _level(n + cap, n, cap, x, fill,
                                                packed, ties, skew)]
    size = torch.tensor(float(budget))
    want = tft_ref.fused_level_tick(*arrs, size, x, out_cap,
                                    allocation=allocation)
    got = tft.fused_level_tick(*(a.to(cuda_device) for a in arrs),
                               size.to(cuda_device), x, out_cap,
                               allocation=allocation)
    for name, g, w in zip(NAMES, got, want):
        _bits(g.cpu().numpy(), w.numpy(), name)


@pytest.mark.cuda
def test_fused_select_kernel_matches_plain(cuda_device):
    vals, strata, valid, u, _, _ = _level(5, 1, 2200, 4, 1.0, True, True)
    t = [torch.from_numpy(a[0]) for a in (u, strata, valid)]
    res = torch.tensor([300.0, 0.0, 250.0, 900.0])
    want = tft_ref.fused_select(*t, res, 4)
    got = tft.fused_select(*(a.to(cuda_device) for a in t),
                           res.to(cuda_device), 4)
    _bits(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_stratified_stats_kernel_matches_plain(cuda_device):
    vals, strata, valid, _, _, _ = _level(6, 1, 5000, 32, 0.8, False)
    t = [torch.from_numpy(a[0]) for a in (vals, strata, valid)]
    want = tss_ref.stratified_stats(*t, 32).numpy()
    got = tss.stratified_stats(*(a.to(cuda_device) for a in t),
                               32).cpu().numpy()
    _bits(got[:, 0], want[:, 0], "count")
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=SUMS_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,x", [(4_400, 64), (20_000, 200), (3_000, 4096)])
def test_stratified_stats_kernel_takes_many_strata(cuda_device, m, x):
    """The ``pallas`` backend counts a flattened level's nodes × strata
    composite strata: more than 32 of them on larger trees."""
    vals, strata, valid, _, _, _ = _level(m + x, 1, m, x, 0.8, False)
    t = [torch.from_numpy(a[0]) for a in (vals, strata, valid)]
    want = tss_ref.stratified_stats(*t, x).numpy()
    got = tss.stratified_stats(*(a.to(cuda_device) for a in t),
                               x).cpu().numpy()
    _bits(got[:, 0], want[:, 0], "count")
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=SUMS_RTOL)


@pytest.mark.cuda
def test_pallas_fused_select_launches_kernel_at_any_size(cuda_device):
    # Beyond the reference's 1 << 22 one-hot limit the backend still
    # launches fused_select once, and agrees with the plain version.
    m, x = 600_000, 8
    assert m * x > 1 << 22
    _, strata, valid, u, _, _ = _level(7, 1, m, x, 0.9, False, True)
    t = [torch.from_numpy(a[0]) for a in (strata, valid, u)]
    c = torch.bincount(t[0][t[1]].long(), minlength=x).float()
    res = torch.minimum(c, torch.arange(1, x + 1).float() * 5000.0)
    want = tft_ref.fused_select(t[2], t[0], t[1], res, x)
    reset_launches()
    got = tsamp.get_backend("pallas_fused").select(
        None, *(a.to(cuda_device) for a in t[:2]), res.to(cuda_device), x,
        priorities=t[2].to(cuda_device))
    assert LAUNCHES["fused_select"] == 1
    _bits(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m,depth,width", [(2200, 4, 1024), (2200, 4, 256),
                                           (512, 4, 256), (4096, 2, 1024),
                                           (5000, 6, 128), (3000, 3, 4096),
                                           (0, 2, 64), (77, 1, 1)])
def test_cms_update_kernel_matches_plain(cuda_device, m, depth, width):
    rng = np.random.default_rng(m + width)
    keys = rng.integers(-2**31, 2**31, m, dtype=np.int64).astype(np.int32)
    keys[: m // 3] = 42                     # one heavy key
    w = rng.uniform(0.1, 40.0, m).astype(np.float32)
    w[rng.random(m) < 0.2] = 0.0
    k, wt = torch.from_numpy(keys), torch.from_numpy(w)
    want = tsk_ref.cms_update(k, wt, depth, width)
    got = tsk.cms_update(k.to(cuda_device), wt.to(cuda_device), depth,
                         width)
    _bits(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m,depth,width,one_key", [
    (2200, 4, 1024, True), (2200, 4, 256, True), (5000, 1, 1, True),
    (32000, 6, 65536, False), (4096, 6, 65536, True), (9000, 6, 512, False),
    (0, 6, 65536, False)])
def test_cms_update_kernel_on_one_key_and_wide_tables(cuda_device, m, depth,
                                                      width, one_key):
    """Every item on one key (one bucket per row takes all M weights, in
    item order), tables up to 65,536 buckets a row, six rows, more items
    than one staged tile: bitwise the plain version."""
    rng = np.random.default_rng(m + depth + width)
    keys = rng.integers(-2**31, 2**31, m, dtype=np.int64).astype(np.int32)
    if one_key:
        keys[:] = -123456789
    w = rng.uniform(0.1, 40.0, m).astype(np.float32)
    w[rng.random(m) < 0.2] = 0.0
    k, wt = torch.from_numpy(keys), torch.from_numpy(w)
    reset_launches()
    got = tsk.cms_update(k.to(cuda_device), wt.to(cuda_device), depth,
                         width)
    assert LAUNCHES["cms_update"] == 1
    _bits(got.cpu().numpy(), tsk_ref.cms_update(k, wt, depth, width).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("p,c", [(2456, 128), (384, 128), (2328, 64),
                                 (704, 64), (1500, 256), (1025, 300),
                                 (5, 3)])
def test_quantile_compact_kernel_matches_plain(cuda_device, p, c):
    rng = np.random.default_rng(p + c)
    v = np.sort(rng.normal(100, 30, p)).astype(np.float32)
    wt = rng.uniform(0.5, 3.0, p).astype(np.float32)
    wt[rng.random(p) < 0.3] = 0.0
    cumw = np.cumsum(wt, dtype=np.float32)
    prev = np.concatenate([[0.0], cumw[:-1]]).astype(np.float32)
    t = ((np.arange(c) + rng.random()) * cumw[-1] / c).astype(np.float32)
    t[-1] = cumw[-1]                        # at the total: no slot
    args = [torch.from_numpy(a) for a in (v, prev, cumw, t)]
    want = tsk_ref.quantile_compact(*args)
    got = tsk.quantile_compact(*(a.to(cuda_device) for a in args))
    _bits(got.cpu().numpy(), want.numpy())
    assert float(got[-1]) == 0.0


def _sketch_intervals(seed, p, c):
    """Intervals as the sketch builds them: ``cumw`` by ``blocked_cumsum``
    (which can fall by an ulp at a block boundary), ``cumw_prev`` shifted
    by one, weights with zeros. Targets sit in every descent (a target
    there lies in two slots) and on a lone ``-0.0`` value; the rest are
    equi-spaced, the last at the total (no slot). Returns the arrays and
    each target's number of hits."""
    rng = np.random.default_rng(seed)
    v = np.sort(rng.normal(0, 30, p)).astype(np.float32)
    w = (rng.uniform(0.5, 3.0, p) * rng.choice([1.0, 7.0, 1000.0], p)
         ).astype(np.float32)
    w[rng.random(p) < 0.3] = 0.0
    cumw = tsketch.blocked_cumsum(torch.from_numpy(w)).numpy()
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
    return [torch.from_numpy(a) for a in (v, prev, cumw, t)], hits


@pytest.mark.cuda
@pytest.mark.parametrize("p,c", [(1025, 64), (2456, 128), (5000, 300),
                                 (65536, 640)])
def test_quantile_compact_kernel_on_sketch_intervals(cuda_device, p, c):
    """A target in a descent of the blocked cumsum hits two slots, and the
    plain version adds both; a lone ``-0.0`` hit gives ``+0.0``; more than
    one block of targets; up to 65,536 slots."""
    args, hits = _sketch_intervals(p + c, p, c)
    assert (hits == 2).any() and hits[-2] == 1 and hits[-1] == 0
    want = tsk_ref.quantile_compact(*args)
    reset_launches()
    got = tsk.quantile_compact(*(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert LAUNCHES["quantile_compact"] == 1
    _bits(got.cpu().numpy(), want.numpy())
    assert float(want[-2]) == 0.0 and not np.signbit(want.numpy()[-2])


@pytest.mark.cuda
def test_sketch_updates_launch_their_kernels(cuda_device):
    """One ``cms_update`` launch per ``hh_update``; one
    ``quantile_compact`` launch per level of a ``quantile_update`` (the
    compaction runs at every level, selected on the device); the states
    equal the CPU run's."""
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.normal(60, 15, 2200).astype(np.float32))
    w = torch.from_numpy(((rng.random(2200) < 0.5) * 9.25).astype(
        np.float32))
    u = torch.from_numpy(rng.random(4).astype(np.float32))
    hh_cpu = tsketch.hh_update(tsketch.hh_init(8, 1024, 4),
                               tsketch.hh_item_key(v), w)
    q_cpu = tsketch.quantile_update(u, tsketch.quantile_init(256), v, w)
    reset_launches()
    d = cuda_device
    hh = tsketch.hh_update(tsketch.hh_init(8, 1024, 4, d),
                           tsketch.hh_item_key(v.to(d)), w.to(d))
    assert LAUNCHES["cms_update"] == 1
    q = tsketch.quantile_update(u.to(d), tsketch.quantile_init(256, d),
                                v.to(d), w.to(d))
    assert LAUNCHES["quantile_compact"] == 4
    for a, b in zip(hh + q, hh_cpu + q_cpu):
        _bits(a.cpu().numpy(), b.numpy())


def _on_card_at(a, offset, device):
    """``a`` on the card as a view at storage offset ``offset`` items."""
    return torch.empty(offset + a.shape[0], dtype=a.dtype,
                       device=device)[offset:].copy_(a)


@pytest.mark.cuda
@pytest.mark.parametrize("m,x,ties,offset,special", [
    (44_032, 16, False, 0, False), (4_400, 8, False, 0, False),
    (2_200, 4, True, 0, False), (1, 4, False, 0, False),
    (333, 2, True, 0, False), (44_033, 32, True, 0, False),
    (5_000, 6144, False, 0, False),
    # the vector path's tail (M mod 4) and one stratum
    (2, 4, False, 0, False), (3, 1, True, 0, False), (5, 3, False, 0, False),
    (7, 2, True, 0, False), (1_023, 16, False, 0, False),
    (2_200, 1, False, 0, False),
    # views at storage offsets 1-3 items (the kernel's scalar path) and 4
    # (a view the vector path takes), NaN priorities and -0.0 against
    # tau = +0.0, up to the most strata
    (1_023, 4, False, 1, True), (44_033, 16, True, 2, True),
    (4_400, 8, False, 3, True), (2_200, 4, True, 4, True),
    (44_032, 6144, False, 0, True), (9, 1, False, 1, True)])
def test_sample_mask_kernel_matches_plain(cuda_device, m, x, ties, offset,
                                          special):
    rng = np.random.default_rng(m + x)
    u = (rng.integers(0, 41, m) / 41.0 if ties else rng.random(m)).astype(
        np.float32)
    strata = rng.integers(0, x, m).astype(np.int32)
    valid = rng.random(m) < 0.85
    strata[~valid] = rng.integers(-3 * x, 3 * x, int((~valid).sum()))
    res = torch.from_numpy(rng.integers(0, max(m // x, 2), x).astype(
        np.float32))
    res[0] = 0.0                               # keep none: τ = +2
    res[-1] = float(m)                         # keep all: τ = −1
    t = [torch.from_numpy(a) for a in (u, strata, valid)]
    tau = tsm.thresholds_from_reservoirs(*t, res, x)
    tau_card = tsm.thresholds_from_reservoirs(
        *(a.to(cuda_device) for a in t), res.to(cuda_device), x)
    _bits(tau_card.cpu().numpy(), tau.numpy(), "tau")
    if special:
        j = x // 2
        tau[j] = 0.0
        mine = np.flatnonzero(strata == j)
        t[0][mine[0::2]] = -0.0                # kept at τ = +0.0
        t[0][mine[1::4]] = 0.0
        t[0][3::11] = float("nan")             # never kept
    w = torch.from_numpy(rng.uniform(0.5, 9.0, x).astype(np.float32))
    want = tsm_ref.sample_mask(*t, tau, w)
    reset_launches()
    got = tsm.sample_mask(*(_on_card_at(a, offset, cuda_device) for a in t),
                          tau.to(cuda_device), w.to(cuda_device))
    torch.cuda.synchronize()
    assert LAUNCHES["sample_mask"] == 1
    for g, wnt, name in zip(got, want, ("keep", "w")):
        _bits(g.cpu().numpy(), wnt.numpy(), name)


def _ordered_inputs(rng, rows, m, x):
    """Mixed magnitudes from 1e-3 to 1e6 with alternating signs, so every
    reordering of a segment's adds changes its f32 sum; some ids fall
    outside [0, X)."""
    mag = 10.0 ** rng.uniform(-3, 6, (rows, m))
    sign = np.where(np.arange(m) % 2 == 0, 1.0, -1.0)
    vals = (mag * sign).astype(np.float32)
    ids = rng.integers(-2, x + 2, (rows, m)).astype(np.int64)
    return torch.from_numpy(vals), torch.from_numpy(ids)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,m,x", [(1, 1, 1), (1, 2_200, 4),
                                      (4, 11_008, 4), (1, 44_032, 16),
                                      (2, 4_400, 64), (3, 777, 33),
                                      (1, 64, 1)])
def test_segment_sum_kernel_matches_cpu_order(cuda_device, rows, m, x):
    rng = np.random.default_rng(rows * m + x)
    vals, ids = _ordered_inputs(rng, rows, m, x)
    want = tseg_ref.segment_sum(vals, ids, x)
    reset_launches()
    got = tseg.segment_sum(vals.to(cuda_device), ids.to(cuda_device), x)
    torch.cuda.synchronize()
    assert LAUNCHES["segment_sum"] == 1
    _bits(got.cpu().numpy(), want.numpy())
    # int32 ids go in as they are; int64 ids that would wrap into [0, X)
    # if narrowed to int32 are still dropped
    got32 = tseg.segment_sum(vals.to(cuda_device),
                             ids.to(torch.int32).to(cuda_device), x)
    wide = torch.where(ids % 3 == 0, ids + (1 << 32), ids)
    got_wide = tseg.segment_sum(vals.to(cuda_device), wide.to(cuda_device), x)
    torch.cuda.synchronize()
    assert LAUNCHES["segment_sum"] == 3
    _bits(got32.cpu().numpy(), want.numpy())
    _bits(got_wide.cpu().numpy(),
          tseg_ref.segment_sum(vals, wide, x).numpy())
    # integer sums keep PyTorch's exact path: no launch
    counts = tseg.segment_sum(torch.ones_like(ids, device=cuda_device),
                              ids.to(cuda_device), x)
    assert LAUNCHES["segment_sum"] == 3
    _bits(counts.cpu().numpy(),
          tseg_ref.segment_sum(torch.ones_like(ids), ids, x).numpy())


def _same_sums(got, want):
    """Bitwise, with NaN compared as NaN (the card's NaN is not the CPU's
    payload or sign)."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    _bits(np.where(nan, 0.0, got).astype(np.float32),
          np.where(nan, 0.0, want).astype(np.float32))


def _segment_case(case, rng):
    """(values, int64 ids, S) of the redesign's edge cases."""
    if case == "longer_than_a_chunk":
        vals, ids = _ordered_inputs(rng, 1, 100_003, 4)
        return vals, ids, 4
    if case == "one_segment_holds_all":
        vals, _ = _ordered_inputs(rng, 2, 20_000, 3)
        return vals, torch.ones((2, 20_000), dtype=torch.int64), 3
    if case == "more_segments_than_threads":
        vals, ids = _ordered_inputs(rng, 2, 30_000, 1_500)
        return vals, ids, 1_500
    if case == "every_id_out_of_range":
        vals, ids = _ordered_inputs(rng, 2, 5_000, 8)
        return vals, torch.where(ids % 2 == 0, ids.abs() + 8,
                                 -1 - ids.abs()), 8
    vals, ids = _ordered_inputs(rng, 2, 9_000, 8)     # special values
    ids = torch.where(ids < 4, 4, ids)
    vals[:, 0], ids[:, 0] = -0.0, 0          # segment 0: -0.0 alone
    vals[:, 1], ids[:, 1] = float("inf"), 1
    vals[:, 2], vals[:, 3] = float("inf"), float("-inf")
    ids[:, 2:4] = 2                          # inf + -inf: NaN
    vals[:, 5], ids[:, 5] = float("nan"), 3
    return vals, ids, 8


@pytest.mark.cuda
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["longer_than_a_chunk",
                                  "one_segment_holds_all",
                                  "more_segments_than_threads",
                                  "every_id_out_of_range", "special_values"])
def test_segment_sum_kernel_on_edge_cases(cuda_device, case, ids_dtype):
    """Rows longer than one staging chunk, the longest chain (one segment
    holds every item), more segments than the block has threads, no id
    in range, and -0.0, inf and NaN: bitwise the CPU's item order."""
    vals, ids, x = _segment_case(case, np.random.default_rng(99))
    ids = ids.to(ids_dtype)
    want = tseg_ref.segment_sum(vals, ids, x)
    got = tseg.segment_sum(vals.to(cuda_device), ids.to(cuda_device), x)
    torch.cuda.synchronize()
    _same_sums(got.cpu().numpy(), want.numpy())


# The root's counts on ``pallas_fused`` and the ``pallas`` backend's three
# launches a tick (level 0 flattened, level 1, the root); then both sides
# of the kernel's change of layout (a row a thread up to 24 strata, a row
# a warp above), the former on a full cluster of 8 CTAs.
STATS_SHAPES = [(2_200, 4), (44_032, 16), (4_400, 8), (40_000, 24),
                (9_000, 25)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,x", STATS_SHAPES)
def test_stratified_stats_kernel_at_path_shapes(cuda_device, m, x):
    vals, strata, valid, _, _, _ = _level(m * x, 1, m, x, 0.8, False)
    t = [torch.from_numpy(a[0]) for a in (vals, strata, valid)]
    want = tss_ref.stratified_stats(*t, x).numpy()
    got = tss.stratified_stats(*(a.to(cuda_device) for a in t),
                               x).cpu().numpy()
    _bits(got[:, 0], want[:, 0], "count")
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=SUMS_RTOL)
    # the path's own call: zeros as values, counts only
    zeros = torch.zeros(m)
    want0 = tss_ref.stratified_stats(zeros, *t[1:], x).numpy()
    got0 = tss.stratified_stats(*(a.to(cuda_device) for a in
                                  (zeros, *t[1:])), x).cpu().numpy()
    _bits(got0, want0)


def _device_ops(fn, calls=10):
    """Names of the device operations (kernels, fills, copies) that
    ``calls`` calls of ``fn`` run, from a profiler trace, after a warm-up
    call. A trace can lose events near its start and end, so the calls
    lie between two runs of spin kernels (left out of the list), and a
    trace whose count is not a multiple of ``calls`` is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.name]
        if ops and len(ops) % calls == 0:
            return ops
    return ops


@pytest.mark.cuda
def test_each_call_is_one_kernel_and_no_fill(cuda_device):
    """``segment_sum`` allocates its output empty (the kernel writes every
    element) and ``stratified_stats`` takes one launch and no scratch:
    each call is exactly one device operation, its own kernel."""
    rng = np.random.default_rng(5)
    vals, ids = (a.to(cuda_device) for a in _ordered_inputs(rng, 4, 11_008,
                                                             4))
    ops = _device_ops(lambda: tseg.segment_sum(vals, ids, 4))
    assert len(ops) == 10 and all("segment_sum" in n for n in ops), ops
    _, strata, valid, _, _, _ = _level(7, 1, 44_032, 16, 0.8, False)
    z = torch.zeros(44_032, device=cuda_device)
    s, k = (torch.from_numpy(a[0]).to(cuda_device) for a in (strata, valid))
    ops = _device_ops(lambda: tss.stratified_stats(z, s, k, 16))
    assert len(ops) == 10 and all("stratified_stats" in n for n in ops), ops


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_sample_mask_call_is_one_kernel(cuda_device, offset):
    """One ``sample_mask`` call is one launch of its kernel and no other
    device operation (no fill, no copy), on the vector path and on a view
    that takes the scalar path."""
    vals, strata, valid, u, _, _ = _level(11, 1, 44_032, 16, 0.8, False)
    t = [_on_card_at(torch.from_numpy(a[0]), offset, cuda_device)
         for a in (u, strata, valid)]
    tau = torch.rand(16, device=cuda_device)
    w = torch.rand(16, device=cuda_device)
    ops = _device_ops(lambda: tsm.sample_mask(*t, tau, w))
    assert len(ops) == 10 and all("sample_mask" in n for n in ops), ops


@pytest.mark.cuda
def test_pallas_backend_and_neyman_launch_their_kernels(cuda_device):
    """A flattened level through the ``pallas`` backend: one
    ``stratified_stats`` launch, one ``sample_mask`` launch,
    and with neyman the stds' two float sums through ``segment_sum``;
    bitwise the CPU run."""
    from repro_torch.core import whs as twhs

    vals, strata, valid, u, w_in, c_in = _level(9, 4, 11008, 4, 0.73, True)
    cpu = [torch.from_numpy(a) for a in (vals, strata, valid, w_in, c_in)]
    size = torch.tensor(1100.0)
    kw = dict(allocation="neyman", backend="pallas",
              priorities=torch.from_numpy(u))
    want = twhs.level_whsamp(None, *cpu, size, 4, **kw)
    reset_launches()
    got = twhs.level_whsamp(None, *(a.to(cuda_device) for a in cpu),
                            size.to(cuda_device), 4,
                            **dict(kw, priorities=kw["priorities"].to(
                                cuda_device)))
    torch.cuda.synchronize()
    assert (LAUNCHES["stratified_stats"], LAUNCHES["sample_mask"],
            LAUNCHES["segment_sum"]) == (1, 1, 2)
    for name in ("selected", "c", "y", "reservoir"):
        _bits(getattr(got, name).cpu().numpy(),
              getattr(want, name).numpy(), name)
    _bits(got.meta.weight.cpu().numpy(), want.meta.weight.numpy(), "w")


@pytest.mark.cuda
def test_pallas_backend_on_a_wide_level(cuda_device):
    """8 nodes × 8 strata: 64 composite strata in one flattened level."""
    from repro_torch.core import whs as twhs

    vals, strata, valid, u, w_in, c_in = _level(10, 8, 2048, 8, 0.9, False)
    cpu = [torch.from_numpy(a) for a in (vals, strata, valid, w_in, c_in)]
    size = torch.tensor(300.0)
    want = twhs.level_whsamp(None, *cpu, size, 8, backend="pallas",
                             priorities=torch.from_numpy(u))
    got = twhs.level_whsamp(None, *(a.to(cuda_device) for a in cpu),
                            size.to(cuda_device), 8, backend="pallas",
                            priorities=torch.from_numpy(u).to(cuda_device))
    for name in ("selected", "c", "y", "reservoir"):
        _bits(getattr(got, name).cpu().numpy(),
              getattr(want, name).numpy(), name)


# taxi-zones.peak-f10's neyman launches (bench/configs/approxiot-taxi-zones
# .json): 263 zones with Zipf shares and fares N(mu_r, mu_r / 4), so the
# radix digits are 6 bits wide, the allocation's arrays live in the global
# scratch and the moments walk the valid prefix in 3 windows of 128 strata.
# (n, cap, budget, fill, out_capacity)
TAXI_ZONES = 263
TAXI_GRID = [(4, 2700032, 270003, 0.74, 270003),    # L0
             (2, 540006, 54000, 1.0, 54000)]        # L1


def _taxi_level(seed, n, cap, fill):
    rng = np.random.default_rng(seed)
    r = np.arange(1, TAXI_ZONES + 1)
    strata = rng.choice(TAXI_ZONES, (n, cap),
                        p=(1.0 / r) / (1.0 / r).sum()).astype(np.int32)
    mu = 10.0 + 30.0 * strata / 262
    vals = rng.normal(mu, mu / 4).astype(np.float32)
    counts = rng.integers(int(0.99 * fill * cap), int(fill * cap) + 1, n)
    valid = np.arange(cap)[None, :] < counts[:, None]
    u = rng.random((n, cap)).astype(np.float32)
    w_in = np.abs(rng.normal(1, 0.2, (n, TAXI_ZONES))).astype(np.float32)
    c_in = rng.integers(0, 500, (n, TAXI_ZONES)).astype(np.float32)
    return vals, strata, valid, u, w_in, c_in


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap,budget,fill,out_cap", TAXI_GRID)
def test_fused_level_tick_kernel_at_taxi_zones(cuda_device, n, cap, budget,
                                               fill, out_cap):
    arrs = [torch.from_numpy(a) for a in _taxi_level(n + cap, n, cap, fill)]
    size = torch.tensor(float(budget))
    want = tft_ref.fused_level_tick(*arrs, size, TAXI_ZONES, out_cap,
                                    allocation="neyman")
    reset_launches()
    got = tft.fused_level_tick(*(a.to(cuda_device) for a in arrs),
                               size.to(cuda_device), TAXI_ZONES, out_cap,
                               allocation="neyman")
    torch.cuda.synchronize()
    assert LAUNCHES["fused_level_tick"] == 1
    assert tft.regime(TAXI_ZONES, "neyman") == {
        "digit_bits": 6, "radix_passes": 6, "moment_windows": 3}
    for name, g, w in zip(NAMES, got, want):
        _bits(g.cpu().numpy(), w.numpy(), name)


# ---- pallas_fused above 32 strata per node ---------------------------------
# (n, cap, X, budget, fill, packed, allocation, out_capacity, ties)
WIDE_GRID = [
    (2, 4096, 33, 900, 0.9, False, "fair", 800, False),
    (4, 11008, 64, 1100, 0.73, True, "neyman", 1100, True),
    (2, 8192, 64, 2000, 0.8, False, "proportional", 1500, False),
    (2, 8192, 1000, 1500, 0.9, False, "proportional", 1200, False),
    (1, 8192, 1000, 3000, 0.95, True, "fair", 3000, True),
    (1, 8192, 1000, 2500, 0.9, False, "neyman", 2000, False),
    (3, 3333, 40, 800, 0.8, False, "neyman", 700, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,cap,x,budget,fill,packed,allocation,out_cap,ties", WIDE_GRID)
def test_fused_level_tick_kernel_takes_many_strata(cuda_device, n, cap, x,
                                                   budget, fill, packed,
                                                   allocation, out_cap,
                                                   ties):
    """More than 32 strata per node: the per-stratum state moved to
    dynamic shared memory and a global scratch; still bitwise."""
    arrs = [torch.from_numpy(a) for a in _level(n + cap + x, n, cap, x, fill,
                                                packed, ties)]
    size = torch.tensor(float(budget))
    want = tft_ref.fused_level_tick(*arrs, size, x, out_cap,
                                    allocation=allocation)
    reset_launches()
    got = tft.fused_level_tick(*(a.to(cuda_device) for a in arrs),
                               size.to(cuda_device), x, out_cap,
                               allocation=allocation)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_level_tick"] == 1
    for name, g, w in zip(NAMES, got, want):
        _bits(g.cpu().numpy(), w.numpy(), name)


@pytest.mark.cuda
@pytest.mark.parametrize("m,x", [(2_200, 33), (8_800, 64), (20_000, 1000)])
def test_fused_select_kernel_takes_many_strata(cuda_device, m, x):
    _, strata, valid, u, _, _ = _level(m + x, 1, m, x, 0.9, False, True)
    t = [torch.from_numpy(a[0]) for a in (u, strata, valid)]
    c = torch.bincount(t[1][t[2]].long(), minlength=x).float()
    res = torch.minimum(c, torch.arange(x).float() % 7 + 1.0)
    want = tft_ref.fused_select(*t, res, x)
    got = tft.fused_select(*(a.to(cuda_device) for a in t),
                           res.to(cuda_device), x)
    _bits(got.cpu().numpy(), want.numpy())


def _degenerate(arrs, x, fill_equal=0.37):
    """Stratum 0's valid priorities all equal, stratum ``x - 1`` (when
    ``x > 1``) without a valid item."""
    vals, strata, valid, u, w_in, c_in = (a.copy() for a in arrs)
    u[strata == 0] = np.float32(fill_equal)
    if x > 1:
        valid[strata == x - 1] = False
    return vals, strata, valid, u, w_in, c_in


# (n, cap, X, budget, allocation, out_capacity, ties): X at both sides of
# every change of the radix digit's width (fused_level_tick digit_bits),
# and 4,096; neyman above 32 strata; n_eff = 1 (budget = X).
CHANGES_X = [102, 103, 204, 205, 400, 401, 771, 772, 1439, 1440, 2535,
             2536, 4096]
CLUSTER_GRID = (
    [(1, 9000, x, 3000, "fair", 2000, x % 2 == 0) for x in CHANGES_X]
    + [(2, 4096, 100, 900, "neyman", 900, True),
       (1, 8192, 4096, 5000, "neyman", 4000, False),
       (2, 4099, 4, 4, "fair", 64, True),            # n_eff = 1 each
       (3, 2200, 8, 8, "proportional", 8, False),    # n_eff = 1 each
       (2, 4096, 4, 700, "fair", 700, False)])


@pytest.mark.cuda
def test_fused_level_tick_digit_bits_match_the_wrapper(cuda_device):
    lib = tft._lib()
    assert [lib.fused_level_tick_digit_bits(x) for x in range(1, 4097)] == [
        tft.digit_bits(x) for x in range(1, 4097)]
    changes = [x for x in range(2, 4097)
               if tft.digit_bits(x) != tft.digit_bits(x - 1)]
    assert changes == CHANGES_X[1:-1:2]


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap,x,budget,allocation,out_cap,ties",
                         CLUSTER_GRID)
def test_cluster_kernels_on_edge_strata(cuda_device, n, cap, x, budget,
                                        allocation, out_cap, ties):
    """The cluster design at every digit width, with a stratum of equal
    priorities and one without a valid item: ``fused_level_tick`` and
    ``fused_select`` (over its allocation) bitwise the plain version."""
    arrs = _degenerate(_level(n + cap + x, n, cap, x, 0.9, False, ties), x)
    arrs = [torch.from_numpy(a) for a in arrs]
    size = torch.tensor(float(budget))
    want = tft_ref.fused_level_tick(*arrs, size, x, out_cap,
                                    allocation=allocation)
    reset_launches()
    got = tft.fused_level_tick(*(a.to(cuda_device) for a in arrs),
                               size.to(cuda_device), x, out_cap,
                               allocation=allocation)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_level_tick"] == 1
    for name, g, w in zip(NAMES, got, want):
        _bits(g.cpu().numpy(), w.numpy(), name)
    t = [arrs[3][0], arrs[1][0], arrs[2][0]]
    for res in (want[5][0], torch.ones(x)):
        w_sel = tft_ref.fused_select(*t, res, x)
        g_sel = tft.fused_select(*(a.to(cuda_device) for a in t),
                                 res.to(cuda_device), x)
        _bits(g_sel.cpu().numpy(), w_sel.numpy(), "fused_select")


# ---- flash_attention ---------------------------------------------------------
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfa_ref  # noqa: E402

# The reference test's shapes (B, Hq, Hkv, S, D), and SmolLM-135M's prefill.
FLASH_SHAPES = [(1, 2, 1, 128, 64), (2, 4, 2, 256, 64), (1, 8, 2, 256, 128),
                (2, 3, 3, 128, 32)]
SMOLLM_PREFILL = (8, 9, 3, 2048, 64)
FLASH_F32_TOL = 1e-5


def _qkv(shape, dtype, seed=0):
    b, hq, hkv, s, d = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dtype)
            for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers (8 significant bits) at |x|."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def assert_flash_close(got: torch.Tensor, want: torch.Tensor) -> None:
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    # bf16: the kernel and the plain version round p at the same values
    # (same kv blocks, same running max) and differ only in the order of
    # their f32 sums before the final rounding to bf16, so an element may
    # land one bf16 ulp away: the ulp at its own magnitude, and near zero
    # at the output's RMS magnitude.
    rms = want.pow(2).mean().sqrt()
    tol = torch.maximum(_bf16_ulp(want), _bf16_ulp(rms))
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda_device, shape, dtype):
    q, k, v = (t.to(cuda_device) for t in _qkv(shape, dtype))
    want = tfa_ref.flash_attention(q, k, v)
    reset_launches()
    got = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        # f32: only the order of the f32 sums and exp's last bit differ.
        torch.testing.assert_close(got, want, rtol=FLASH_F32_TOL,
                                   atol=FLASH_F32_TOL)
    else:
        assert_flash_close(got, want)


@pytest.mark.cuda
def test_flash_attention_kernel_at_smollm_prefill(cuda_device):
    q, k, v = (t.to(cuda_device) for t in _qkv(SMOLLM_PREFILL,
                                                torch.bfloat16, 1))
    want = tfa_ref.flash_attention(q, k, v)
    got = tfa.flash_attention(q, k, v)
    assert_flash_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 4, 256, 64), (1, 9, 3, 256, 64),
                                   (1, 8, 2, 384, 32)])
def test_flash_attention_kernel_maps_kv_heads(cuda_device, shape, dtype):
    """Query head h reads kv head h // (Hq/Hkv): each kv head gets its own
    offset, so a wrong mapping shows; against the plain version (f32
    ``FLASH_F32_TOL``, bf16 one ulp) and the head-repeating oracle (f32
    1e-4; bf16 2e-2, the reference test's)."""
    q, k, v = _qkv(shape, torch.float32, 2)
    v = v + 10.0 * torch.arange(shape[2]).float()[None, :, None, None]
    q, k, v = (t.to(dtype).to(cuda_device) for t in (q, k, v))
    got = tfa.flash_attention(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, tfa_ref.flash_attention(q, k, v),
                                   rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL)
        torch.testing.assert_close(got, tfa_ref.attention(q, k, v),
                                   rtol=FLASH_F32_TOL, atol=1e-4)
    else:
        assert_flash_close(got, tfa_ref.flash_attention(q, k, v))
        torch.testing.assert_close(got.float(),
                                   tfa_ref.attention(q, k, v).float(),
                                   rtol=2e-2, atol=2e-2)


# The bf16 (tensor-core) kernel's grid of shapes: S from one short block
# to 16 tiles, each head dim, query heads per kv head 1, 3 and 4.
BF16_GRID = [(1, 2 * g, 2, s, d) for s in (16, 64, 128, 256, 2048)
             for d in (32, 64, 128) for g in (1, 3, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_GRID)
def test_flash_attention_bf16_kernel_over_shapes(cuda_device, shape):
    q, k, v = (t.to(cuda_device) for t in _qkv(shape, torch.bfloat16, 3))
    reset_launches()
    got = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_flash_close(got, tfa_ref.flash_attention(q, k, v))


@pytest.mark.cuda
def test_flash_attention_build_failure_raises(cuda_device, tmp_path,
                                              monkeypatch):
    """A kernel that does not build raises on a CUDA tensor; nothing falls
    back to the plain version."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "flash_attention.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    q, k, v = (t.to(cuda_device) for t in _qkv(FLASH_SHAPES[0],
                                                torch.float32))
    reset_launches()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfa.flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == 0


@pytest.mark.cuda
def test_prefill_launches_flash_attention_per_layer(cuda_device):
    """The model's pallas path launches the kernel once per layer, and
    its logits agree with the xla path and with the CPU."""
    import dataclasses

    from repro_torch.configs import registry as treg
    from repro_torch.models import model as tmodel

    cfg = dataclasses.replace(treg.get_config("smollm-135m").reduced(),
                              attention_impl="pallas")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 256)))
    cpu = tmodel.forward(cfg, params, {"tokens": toks})[0]
    reset_launches()
    card = tmodel.forward(cfg, params.to(cuda_device),
                          {"tokens": toks.to(cuda_device)})[0]
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == cfg.num_layers
    xla = tmodel.forward(dataclasses.replace(cfg, attention_impl="xla"),
                         params, {"tokens": toks.to(cuda_device)})[0]
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(card, xla, rtol=1e-4, atol=1e-4)
