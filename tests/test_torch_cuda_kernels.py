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
``index_add_``, on sums whose value depends on their order).
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
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,cap,x,budget,fill,packed,allocation,out_cap,ties", GRID)
def test_fused_level_tick_kernel_matches_plain(cuda_device, n, cap, x,
                                               budget, fill, packed,
                                               allocation, out_cap, ties):
    arrs = [torch.from_numpy(a) for a in _level(n + cap, n, cap, x, fill,
                                                packed, ties)]
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


@pytest.mark.cuda
@pytest.mark.parametrize("m,x,ties", [(44_032, 16, False), (4_400, 8, False),
                                     (2_200, 4, True), (1, 4, False),
                                     (333, 2, True), (44_033, 32, True),
                                     (5_000, 6144, False)])
def test_sample_mask_kernel_matches_plain(cuda_device, m, x, ties):
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
    w = torch.from_numpy(rng.uniform(0.5, 9.0, x).astype(np.float32))
    want = tsm_ref.sample_mask(*t, tau, w)
    reset_launches()
    got = tsm.sample_mask(*(a.to(cuda_device) for a in t),
                          tau.to(cuda_device), w.to(cuda_device))
    torch.cuda.synchronize()
    assert LAUNCHES["sample_mask"] == 1
    for g, wnt, name in zip(got, want, ("keep", "w")):
        _bits(g.cpu().numpy(), wnt.numpy(), name)
    tau_card = tsm.thresholds_from_reservoirs(
        *(a.to(cuda_device) for a in t), res.to(cuda_device), x)
    _bits(tau_card.cpu().numpy(), tau.numpy(), "tau")


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


@pytest.mark.cuda
def test_pallas_backend_and_neyman_launch_their_kernels(cuda_device):
    """A flattened level through the ``pallas`` backend: one
    ``stratified_stats`` call (2 launches), one ``sample_mask`` launch,
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
