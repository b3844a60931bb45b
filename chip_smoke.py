"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives ``src/repro_torch`` only (nothing of JAX or of the JAX package):

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc`` for sm_90a,
   one ``nvcc`` per source, all at once;
2. holds each kernel against its plain PyTorch version on the same
   inputs — the sampler kernels at the paper testbed's shapes and at
   their limit (cap 8192, 32 strata), saturated or not, front-packed or
   not, with ``out_capacity`` below the keep count, with exact f32
   priority ties, for the fair, proportional and neyman allocations;
   ``cms_update`` at the tenants' shapes and the reference test's;
   ``quantile_compact`` at every (slots, targets) shape one root window
   of the tenant path launches and at slot counts that are not a
   multiple of its tile; ``sample_mask`` at the three shapes of the
   ``pallas`` path, with ties and sentinels, and at M = 1, 333, 44,033;
   the ordered ``segment_sum`` against the CPU's ``index_add_`` on sums
   whose value depends on their order. Everything agrees bitwise except
   ``stratified_stats``' Σx and Σx², held to ``SUMS_RTOL`` (a fixed-order
   block reduction, not item order). Then the neyman reservoirs and masks
   of the ``argsort``, ``topk`` and ``pallas`` backends at the testbed's
   level shapes, card against CPU, bitwise;
3. runs the paper testbed (fanin 4→2→1, capacity 11008, 4 strata,
   fraction 0.1, ``pallas_fused``) through ``compile``/``init``/
   ``run_epoch`` on the card, twice: without tenants for ``EPOCHS``
   epochs of ``TICKS`` ticks, and with two tenants of standing queries
   (``k8_registry`` and ``serve_registry``, all eight query kinds) for
   ``Q_EPOCHS`` epochs. Each run starts from launch counts of 0 and
   must launch every kernel of its path as often as the path requires.
   Both are held against the same runs on the CPU, bitwise (answers,
   variances, histograms, state, sketch state) but for the sketches'
   rank and count-min bounds, held to ``SKETCH_BOUND_RTOL``; the SUM
   against the exact sum and its bound; the tenants' quantile answers
   against the exact quantiles and their rank bounds, and their heavy
   hitters against the stream's most frequent key. ``mode="srs"`` runs
   once (its sums, ``torch.sum`` over the buffer, to ``SRS_RTOL``).
   Then the analytics driver (``launch.analytics.run_pipeline``) on the
   testbed as ``build_spec`` builds it: ``level`` and ``scan`` with
   ``pallas``, ``level`` with ``topk`` and neyman, and the skewed Poisson
   mix with ``pallas``; each held bitwise against its CPU run (SUM,
   bound, forwarded counts, per-window ``n_sampled``), within 2σ of the
   exact sum, launching ``sample_mask`` 3 times a tick on ``pallas``;
4. times each kernel at the main path's shapes beside its bound, its
   plain version and (where one exists) one PyTorch call computing the
   same function, as device time from the profiler's CUDA trace, times
   the WHS epochs with and without tenants and the SRS epochs, profiles
   one epoch of each WHS path, and prints the analytics runs' items/s per
   engine and backend;
5. prints a ``kernels`` JSON line and, last, the ``ok`` JSON line.

It exits non-zero, before printing any result, without a CUDA device or
without the repository's ``src`` beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

EPOCHS = 2            # tenant-free WHS path
Q_EPOCHS = 2          # the path with tenants
TICKS = 16
DRIVER_TICKS = 4      # measured ticks of each analytics-driver run
DRIVER_WARMUP = 2
SUMS_RTOL = 1e-5        # Σx, Σx²: fixed-order f32 sums vs item-order sums
# The SRS root's SUM and MEAN are torch.sum over the whole sample buffer,
# which adds in another order on the card; s² = (Σ(x − mean)²)/(n − 1)
# inherits the mean's difference. Card vs CPU run of the SRS path.
SRS_RTOL = {"sum": 1e-5, "mean": 1e-5, "histogram": 1e-5,
            "sum_var": 1e-3, "mean_var": 1e-3}
# The sketches' bounds (quantile rank bound, count-min ε·W) divide by the
# sketch's total weight, a torch.sum over its slots that adds in another
# order on the card. Every other answer and bound, card vs CPU, is bitwise.
SKETCH_BOUND_RTOL = 1e-5
# A quantile answer's rank on the exact stream must lie within its
# reported (compaction) rank bound plus the sampling error of the root's
# HT-weighted sample: RANK_SIGMAS·√(q(1−q)/n) for n items kept.
RANK_SIGMAS = 3.0
SKETCH_KINDS = ("quantile", "windowed_quantile")
HH_KINDS = ("heavy_hitters", "decayed_heavy_hitters")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# H100 SXM data sheet: f32 outside the tensor cores (the sheet gives no
# rate for the int32 compares the kernels mostly do).
ALU_OPS_PER_S = 67e12
REPLACES = {
    "sample_mask": "src/repro/kernels/sample_mask/sample_mask.py:39",
    "fused_level_tick":
        "src/repro/kernels/fused_level_tick/fused_level_tick.py:229",
    "fused_select":
        "src/repro/kernels/fused_level_tick/fused_level_tick.py:310",
    "stratified_stats":
        "src/repro/kernels/stratified_stats/stratified_stats.py:53",
    "cms_update": "src/repro/kernels/sketch_update/sketch_update.py:72",
    "quantile_compact":
        "src/repro/kernels/sketch_update/sketch_update.py:138",
}
SOURCES = {
    "sample_mask": "src/repro_torch/csrc/sample_mask.cu",
    "fused_level_tick": "src/repro_torch/csrc/fused_level_tick.cu",
    "fused_select": "src/repro_torch/csrc/fused_level_tick.cu",
    "stratified_stats": "src/repro_torch/csrc/stratified_stats.cu",
    "cms_update": "src/repro_torch/csrc/sketch_update.cu",
    "quantile_compact": "src/repro_torch/csrc/sketch_update.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max()) if a.numel() else 0.0


def loop_ms(fn, iters: int = 50) -> float:
    """Mean time of one call, by CUDA events around ``iters`` back-to-back
    calls after a warm-up. For a short kernel this is the rate at which
    the host issues the calls, not the kernel's device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call: the summed durations of the device
    operations it launches, from the profiler's CUDA trace over ``iters``
    calls after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        fail("the profiler saw no device time: kernel times not measured")
    return us / iters / 1e3


# --------------------------------------------------------------- inputs --
def level_inputs(rng, n, cap, x, fill, packed, ties=False):
    """A stacked level on the CPU: ``fill·cap`` live items per node."""
    vals = rng.normal(100, 25, (n, cap)).astype(np.float32)
    vals[:, ::7] *= 1000.0           # a second, far wider sub-stream
    strata = rng.integers(0, x, (n, cap)).astype(np.int32)
    live = np.full(n, int(fill * cap))
    if packed:
        valid = np.arange(cap)[None, :] < live[:, None]
    else:
        valid = np.zeros((n, cap), bool)
        for i in range(n):
            valid[i, rng.choice(cap, live[i], replace=False)] = True
    if ties:    # 97 levels: heavy exact f32 ties
        u = (rng.integers(0, 97, (n, cap)) / 97.0).astype(np.float32)
    else:
        u = rng.random((n, cap)).astype(np.float32)
    w_in = np.abs(rng.normal(1, 0.2, (n, x))).astype(np.float32)
    c_in = rng.integers(0, 500, (n, x)).astype(np.float32)
    return [torch.from_numpy(a) for a in (vals, strata, valid, u, w_in, c_in)]


def check_kernels(dev) -> dict:
    """Phase 2: every kernel against its plain version. Returns the
    largest absolute difference seen per kernel."""
    from repro_torch.kernels.fused_level_tick import ops as ft, ref as ft_ref
    from repro_torch.kernels.stratified_stats import ops as ss, ref as ss_ref

    rng = np.random.default_rng(2018)
    err = {"fused_level_tick": 0.0, "fused_select": 0.0,
           "stratified_stats": 0.0}
    names = ("keep", "values_c", "strata_c", "n_keep", "c", "reservoirs",
             "y", "w_out", "c_out")
    # (n, cap, X, budget, out_capacity, fill, packed, allocation, ties)
    cases = [
        (4, 11008, 4, 1100, 1100, 0.73, True, "fair", False),  # testbed L0
        (2, 2200, 4, 1100, 1100, 1.0, True, "fair", False),    # testbed L1
        (2, 2200, 4, 2200, 2200, 1.0, True, "fair", False),    # saturated
        (2, 2200, 4, 5000, 1500, 0.6, False, "fair", False),   # sat., holes
        (3, 4096, 8, 900, 500, 0.9, True, "fair", False),      # OC < keeps
        (2, 4096, 4, 700, 700, 0.8, False, "fair", True),      # exact ties
        (3, 4096, 6, 1000, 1000, 0.9, True, "proportional", False),
        (3, 4096, 6, 1000, 1000, 0.9, False, "neyman", False),
        (3, 8192, 32, 1500, 1200, 0.95, False, "fair", True),  # the limit
        (3, 8192, 32, 1500, 1500, 1.0, True, "neyman", False),
        (2, 8192, 32, 2000, 2000, 0.9, True, "proportional", True),
        (2, 1024, 4, 0, 64, 1.0, True, "fair", False),         # zero budget
    ]
    for n, cap, x, budget, oc, fill, packed, alloc, ties in cases:
        cpu = level_inputs(rng, n, cap, x, fill, packed, ties)
        size = torch.tensor(float(budget))
        plain = ft_ref.fused_level_tick(*cpu, size, x, oc, allocation=alloc)
        card = ft.fused_level_tick(*(t.to(dev) for t in cpu), size.to(dev),
                                   x, oc, allocation=alloc)
        torch.cuda.synchronize()
        for name, p, k in zip(names, plain, card):
            if not same_bits(p, k):
                fail(f"fused_level_tick {name} differs from the plain "
                     f"version at n={n} cap={cap} X={x} budget={budget} "
                     f"out_capacity={oc} {alloc} ties={ties}")
            err["fused_level_tick"] = max(err["fused_level_tick"],
                                          max_abs(p, k))
        # Selection alone, over the allocation just computed and over a
        # saturating one.
        for res in (plain[5][0], plain[4][0] + 1.0):
            p = ft_ref.fused_select(cpu[3][0], cpu[1][0], cpu[2][0], res, x)
            k = ft.fused_select(cpu[3][0].to(dev), cpu[1][0].to(dev),
                                cpu[2][0].to(dev), res.to(dev), x)
            if not same_bits(p, k):
                fail(f"fused_select differs from the plain version at "
                     f"M={cap} X={x} ties={ties}")
            err["fused_select"] = max(err["fused_select"], max_abs(p, k))
        # Per-stratum moments over the kept items.
        p = ss_ref.stratified_stats(cpu[0][0], cpu[1][0], plain[0][0], x)
        k = ss.stratified_stats(cpu[0][0].to(dev), cpu[1][0].to(dev),
                                plain[0][0].to(dev), x)
        if not same_bits(p[:, 0], k[:, 0]):
            fail(f"stratified_stats counts differ at M={cap} X={x}")
        if not torch.allclose(k.cpu()[:, 1:], p[:, 1:], rtol=SUMS_RTOL,
                              atol=0.0):
            fail(f"stratified_stats sums beyond rtol {SUMS_RTOL} at "
                 f"M={cap} X={x}")
        err["stratified_stats"] = max(err["stratified_stats"], max_abs(p, k))
        print(f"kernels vs plain: n={n} cap={cap} X={x} budget={budget} "
              f"out_capacity={oc} fill={fill} packed={packed} {alloc} "
              f"ties={ties}: bitwise equal")
    return err


def intervals(rng, p, c):
    """Value-sorted slots whose shifted-cumsum intervals partition [0, W)
    (a third of them of zero weight), and ``c`` rank targets, the last
    at W (no slot holds it)."""
    v = np.sort(rng.normal(100, 30, p)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, p).astype(np.float32)
    w[rng.random(p) < 0.3] = 0.0
    cumw = np.cumsum(w, dtype=np.float32)
    prev = np.concatenate([[0.0], cumw[:-1]]).astype(np.float32)
    t = ((np.arange(c) + rng.random()) * cumw[-1] / c).astype(np.float32)
    t[-1] = cumw[-1]
    return [torch.from_numpy(a) for a in (v, prev, cumw, t)]


def cms_inputs(rng, m):
    keys = rng.integers(-2**31, 2**31, m, dtype=np.int64).astype(np.int32)
    keys[: m // 3] = rng.integers(0, 50, m // 3)    # heavy keys
    w = rng.uniform(0.1, 40.0, m).astype(np.float32)
    w[rng.random(m) < 0.2] = 0.0
    return torch.from_numpy(keys), torch.from_numpy(w)


def compact_shapes(plan, m):
    """The (slots, targets) shape of every ``quantile_compact`` launch of
    one root window, in launch order, for a tenant plan whose root holds
    ``m`` items: each fold compacts at every level (slots = the level's
    ``C`` + what it receives; targets ``C/2``, ``C`` at the top)."""
    from repro_torch.query.sketches import kll_schedule

    shapes = []
    for tmpl, n in plan.core.groups:
        for sp in tmpl.specs * n:
            if sp.kind not in SKETCH_KINDS:
                continue
            c = sp.capacity
            levels = len(kll_schedule(c))
            folds = [m] if sp.kind == "quantile" else [m, sp.window * c]
            for k, extra in enumerate(folds):
                for h in range(levels):
                    carry = c // 2 if h else 0
                    add = extra if (h == 0 or k == 1) else 0
                    shapes.append((c + carry + add,
                                   c if h == levels - 1 else c // 2))
    return shapes


def check_sketch_kernels(dev, path_shapes) -> dict:
    """Phase 2, sketch kernels: ``cms_update`` and ``quantile_compact``
    against their plain versions, bitwise. Returns the largest absolute
    difference seen per kernel."""
    from repro_torch.kernels.sketch_update import ops as sk, ref as sk_ref

    rng = np.random.default_rng(12)
    err = {"cms_update": 0.0, "quantile_compact": 0.0}
    for m, depth, width in [(2200, 4, 1024), (2200, 4, 256), (512, 4, 256),
                            (4096, 2, 1024), (5000, 6, 128),
                            (32000, 4, 8192)]:
        k, w = cms_inputs(rng, m)
        plain = sk_ref.cms_update(k, w, depth, width)
        card = sk.cms_update(k.to(dev), w.to(dev), depth, width)
        torch.cuda.synchronize()
        if not same_bits(plain, card):
            fail(f"cms_update differs from the plain version at M={m} "
                 f"depth={depth} width={width}")
        err["cms_update"] = max(err["cms_update"], max_abs(plain, card))
    print("cms_update vs plain: (2200, 4, 1024) (2200, 4, 256) "
          "(512, 4, 256) (4096, 2, 1024) (5000, 6, 128) (32000, 4, 8192): "
          "bitwise equal")
    shapes = sorted(set(path_shapes) | {(1025, 300), (3001, 128), (5, 3)})
    for p, c in shapes:
        args = intervals(rng, p, c)
        plain = sk_ref.quantile_compact(*args)
        card = sk.quantile_compact(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        if not same_bits(plain, card):
            fail(f"quantile_compact differs from the plain version at "
                 f"P={p} C={c}")
        err["quantile_compact"] = max(err["quantile_compact"],
                                      max_abs(plain, card))
    print(f"quantile_compact vs plain at (P, C) = {shapes}: bitwise equal")
    return err


# The three sample_mask launches of one tick of the ``pallas`` path on the
# testbed: level 0 flattened (4 nodes x 11,008 items, 4 x 4 composite
# strata), level 1 (2 x 2,200, 2 x 4), the root (2,200, 4).
MASK_SHAPES = ((44_032, 16), (4_400, 8), (2_200, 4))


def mask_inputs(rng, m, x, ties):
    """Priorities, strata, valid for one ``sample_mask`` launch, τ from a
    random allocation with a keep-none (N = 0) and a keep-all (N ≥ c)
    stratum, and per-stratum weights; padding slots carry strata outside
    [0, X)."""
    from repro_torch.kernels.sample_mask import ops as sm

    u = (rng.integers(0, 61, m) / 61.0 if ties else rng.random(m)).astype(
        np.float32)
    strata = rng.integers(0, x, m).astype(np.int32)
    valid = rng.random(m) < 0.8
    strata[~valid] = rng.integers(-2 * x, 2 * x, int((~valid).sum()))
    res = rng.integers(0, max(m // x, 2), x).astype(np.float32)
    res[0], res[-1] = 0.0, float(m)
    t = [torch.from_numpy(a) for a in (u, strata, valid)]
    tau = sm.thresholds_from_reservoirs(*t, torch.from_numpy(res), x)
    w = torch.from_numpy(rng.uniform(0.5, 9.0, x).astype(np.float32))
    return t + [tau, w]


def ordered_inputs(rng, rows, m, x):
    """Values of mixed magnitude (1e-3 to 1e6) with alternating signs, so
    any reordering of a segment's adds changes its f32 sum, and int32 ids
    (the strata's type on the path) of which some fall outside [0, X)."""
    mag = 10.0 ** rng.uniform(-3, 6, (rows, m))
    vals = (mag * np.where(np.arange(m) % 2 == 0, 1.0, -1.0)).astype(
        np.float32)
    ids = rng.integers(-2, x + 2, (rows, m)).astype(np.int32)
    return torch.from_numpy(vals), torch.from_numpy(ids)


def check_slice3_kernels(dev) -> dict:
    """Phase 2, this slice's kernels: ``sample_mask`` against its plain
    version and the ordered ``segment_sum`` against the CPU, bitwise.
    Returns the largest absolute difference seen per kernel."""
    from repro_torch.kernels.sample_mask import ops as sm, ref as sm_ref
    from repro_torch.kernels.segment_sum import ops as seg, ref as seg_ref

    rng = np.random.default_rng(13)
    err = {"sample_mask": 0.0, "segment_sum": 0.0}
    cases = [(m, x, ties) for m, x in MASK_SHAPES for ties in (False, True)]
    cases += [(1, 4, False), (333, 4, True), (44_033, 16, True)]
    for m, x, ties in cases:
        args = mask_inputs(rng, m, x, ties)
        plain = sm_ref.sample_mask(*args)
        card = sm.sample_mask(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        for p, k in zip(plain, card):
            if not same_bits(p, k):
                fail(f"sample_mask differs from the plain version at M={m} "
                     f"X={x} ties={ties}")
            err["sample_mask"] = max(err["sample_mask"], max_abs(p, k))
    print(f"sample_mask vs plain at (M, X, ties) = {cases}: bitwise equal")
    seg_cases = [(1, 1, 1), (1, 2_200, 4), (4, 11_008, 4), (2, 2_200, 4),
                 (1, 44_032, 16), (2, 4_400, 64), (1, 2_200, 64),
                 (3, 777, 33)]
    for rows, m, x in seg_cases:
        vals, ids32 = ordered_inputs(rng, rows, m, x)
        # int64 ids too (the histograms' bins), some beyond int32's range
        ids64 = ids32.to(torch.int64)
        ids64 = torch.where(ids64 % 3 == 0, ids64 + (1 << 32), ids64)
        for ids in (ids32, ids64):
            plain = seg_ref.segment_sum(vals, ids, x)
            card = seg.segment_sum(vals.to(dev), ids.to(dev), x)
            torch.cuda.synchronize()
            if not same_bits(plain, card):
                fail(f"segment_sum differs from the CPU's item-order sums "
                     f"at rows={rows} M={m} X={x} ids {ids.dtype}")
            err["segment_sum"] = max(err["segment_sum"],
                                     max_abs(plain, card))
    print(f"segment_sum vs the CPU (rows, M, X) = {seg_cases}, int32 and "
          f"int64 ids: bitwise equal on order-sensitive sums")
    return err


def check_neyman_masks(dev, S):
    """The neyman allocation on the card, fed by the ordered float sums:
    reservoirs and masks of ``argsort``, ``topk`` and ``pallas`` at the
    testbed's level 0 (one tick of the Gaussian stream), level 1 and the
    root, card against CPU, bitwise."""
    from repro_torch.core import prng, whs
    from repro_torch.core.types import IntervalBatch, StratumMeta

    b = make_ingest(S, 1, 11008)[0]
    v0 = torch.from_numpy(b.values[0])
    s0 = torch.from_numpy(b.strata[0])
    ok0 = torch.arange(11008)[None, :] < torch.from_numpy(b.counts[0])[:, None]
    rng = np.random.default_rng(21)
    l1 = level_inputs(rng, 2, 2200, 4, 1.0, True)
    root = level_inputs(rng, 1, 2200, 4, 0.9, False)
    levels = {"level 0": (v0, s0, ok0, torch.ones(4, 4), torch.zeros(4, 4)),
              "level 1": (l1[0], l1[1], l1[2], l1[4], l1[5])}
    key = prng.PRNGKey(0)
    size = torch.tensor(1100.0)
    for backend in ("argsort", "topk", "pallas"):
        for name, (v, st, ok, w, c) in levels.items():
            n, cap = v.shape
            prio = prng.uniform(prng.split(key, n), (cap,))
            res = []
            for d in ("cpu", dev):
                r = whs.level_whsamp(
                    None, *(a.to(d) for a in (v, st, ok, w, c)), size.to(d),
                    4, allocation="neyman", backend=backend,
                    max_reservoir=1100, priorities=prio.to(d))
                res.append(r)
            for f in ("selected", "reservoir", "c", "y"):
                if not same_bits(getattr(res[0], f), getattr(res[1], f)):
                    fail(f"neyman {backend} {name}: {f} differs between the "
                         f"card and the CPU")
        batch = IntervalBatch(root[0][0], root[1][0], root[2][0],
                              StratumMeta(root[4][0], root[5][0]))
        res = [whs.whsamp(key.to(d), IntervalBatch(
                   *(a.to(d) for a in batch[:3]),
                   StratumMeta(*(a.to(d) for a in batch.meta))),
                   size.to(d), 4, allocation="neyman", backend=backend,
                   max_reservoir=1100) for d in ("cpu", dev)]
        for f in ("selected", "reservoir", "y"):
            if not same_bits(getattr(res[0], f), getattr(res[1], f)):
                fail(f"neyman {backend} root: {f} differs between the card "
                     f"and the CPU")
        if not same_bits(res[0].meta.weight, res[1].meta.weight):
            fail(f"neyman {backend} root: W^out differs")
    print("neyman reservoirs and masks (argsort, topk, pallas; level 0 "
          "[4, 11008] of one stream tick, level 1 [2, 2200], root [2200]): "
          "card and CPU bitwise")


# (name, --dist, --engine, --backend, --allocation) of the analytics runs.
DRIVER_RUNS = (("level pallas", "gaussian", "level", "pallas", "fair"),
               ("scan pallas", "gaussian", "scan", "pallas", "fair"),
               ("level topk neyman", "gaussian", "level", "topk", "neyman"),
               ("level pallas skewed", "poisson-skewed", "level", "pallas",
                "fair"))


def run_driver(A, device, dist, engine, backend, allocation):
    return A.run_pipeline(A.stream_specs(dist), fraction=0.1,
                          ticks=DRIVER_TICKS, warmup_ticks=DRIVER_WARMUP,
                          seed=0, engine=engine, sampler_backend=backend,
                          allocation=allocation, device=device)


def check_driver(A, dev, LAUNCHES, reset_launches) -> dict:
    """The analytics driver on the card, each run from launch counts of
    0, against the same run on the CPU. Returns {run name: (report,
    launches)}."""
    out = {}
    for name, dist, engine, backend, alloc in DRIVER_RUNS:
        reset_launches()
        card = run_driver(A, dev, dist, engine, backend, alloc)
        launches = dict(LAUNCHES)
        cpu = run_driver(A, "cpu", dist, engine, backend, alloc)
        for k in ("approx_sum", "bound_2sigma", "exact_sum",
                  "items_ingested", "items_forwarded", "n_sampled",
                  "dispatches", "windows"):
            if card[k] != cpu[k]:
                fail(f"driver {name}: {k} differs between the card "
                     f"({card[k]}) and the CPU ({cpu[k]})")
        if card["windows"] != DRIVER_TICKS or not np.isfinite(
                card["approx_sum"]):
            fail(f"driver {name}: expected {DRIVER_TICKS} finite windows")
        if not card["within_2sigma"]:
            fail(f"driver {name}: SUM {card['approx_sum']} not within its "
                 f"2-sigma bound {card['bound_2sigma']} of the exact "
                 f"{card['exact_sum']}")
        # Every tick, warm-up included (the scan engine warms up with one
        # whole epoch): 3 sample_mask and 3 stratified_stats on pallas;
        # the root's moments and histogram, 6 float segment sums, and 2
        # more per level with neyman.
        ticks = DRIVER_TICKS + (DRIVER_TICKS if engine == "scan"
                                else DRIVER_WARMUP)
        pallas = backend == "pallas"
        want = {"sample_mask": 3 * ticks if pallas else 0,
                "stratified_stats": 3 * ticks if pallas else 0,
                "segment_sum": (12 if alloc == "neyman" else 6) * ticks,
                "fused_level_tick": 0, "fused_select": 0, "cms_update": 0,
                "quantile_compact": 0}
        if launches != want:
            fail(f"driver {name}: launches {launches}, expected {want}")
        print(f"driver {name} ({dist}, {engine}, {backend}, {alloc}): SUM "
              f"{card['approx_sum']:.6e} +/- {card['bound_2sigma']:.3e}, "
              f"exact {card['exact_sum']:.6e}, within 2 sigma; forwarded "
              f"{card['items_forwarded']}; n_sampled {card['n_sampled']}; "
              f"card and CPU bitwise; launches {launches}; "
              f"{card['throughput_items_s']:.4g} items/s on the card, "
              f"{cpu['throughput_items_s']:.4g} on the CPU")
        out[name] = (card, launches)
    return out


# ------------------------------------------------------------ main path --
def k8_registry(Q):
    """The K=8 standing-query mix of ``benchmarks/fig8_accuracy.py``
    (``k8_registry``): sum, count, mean, two histograms, quantiles and a
    median at capacity 256, heavy hitters k=8 over a 4×1024 table."""
    return (Q().register_sum().register_count().register_mean()
            .register_histogram("hist_coarse", 0.0, 120_000.0, 16)
            .register_histogram("hist_fine", 0.0, 2_000.0, 32)
            .register_quantile("quantiles", (0.5, 0.9, 0.99), capacity=256)
            .register_quantile("median", (0.5,), capacity=256)
            .register_heavy_hitters("heavy", k=8, width=1024, depth=4))


def serve_registry(Q, window=4):
    """The serving dashboard of ``launch/serve.py`` (``serve_registry``):
    count, sum, mean, quantiles at capacity 256, windowed quantiles at
    capacity 128 over ``window`` windows, decayed heavy hitters k=4 over
    a 4×256 table."""
    return (Q().register_count("requests")
            .register_sum("latency_total_ms")
            .register_mean("latency_mean_ms")
            .register_quantile("latency_q_ms", qs=(0.5, 0.99), capacity=256)
            .register_windowed_quantile("latency_q_recent_ms",
                                        qs=(0.5, 0.99), capacity=128,
                                        window=window)
            .register_decayed_heavy_hitters("hot_latency_keys", k=4,
                                            width=256, decay=0.8))


def tenant_spec(P):
    """The testbed with two tenants of different query shapes (two slot
    groups), all eight query kinds between them."""
    import dataclasses

    from repro_torch.query import QueryRegistry as Q

    return dataclasses.replace(
        testbed_spec(P), tenants=(k8_registry(Q).as_tenant("k8"),
                                  serve_registry(Q).as_tenant("dashboard")))


def testbed_spec(P, mode="whs"):
    """The paper's §V testbed job: 8 sources of the four Gaussian
    sub-streams at 1000 items/tick each, fanin 4→2→1, level-0 capacity
    for the offered load with 35% slack (11008), fraction 0.1."""
    per_node_rate = 4 * 1000 * 8 / 4
    capacity = max(int(1.35 * per_node_rate) + 256 & ~255, 1024)
    return P.PipelineSpec(
        topology=P.TopologySpec(fanin=(4, 2, 1), capacity=capacity,
                                num_strata=4),
        sampler=P.SamplerSpec(mode=mode, backend="pallas_fused",
                              allocation="fair", fraction=0.1),
        telemetry=P.TelemetrySpec(enabled=True), seed=0)


def make_ingest(S, epochs, width):
    sources = [S.StreamSource(S.paper_gaussian(), seed=i) for i in range(8)]
    return [S.batch_ingest(sources, TICKS, 4, width) for _ in range(epochs)]


def run_path(P, spec, device, batches):
    """Run the epochs; returns (state, answers per epoch, seconds per
    epoch, items per epoch)."""
    pipe = P.compile(spec, device=device)
    state = pipe.init()
    answers, secs, items = [], [], []
    for b in batches:
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, wa = pipe.run_epoch(state, pipe.default_key, b.values,
                                   b.strata, b.counts)
        if device != "cpu":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        items.append(int(b.counts.sum()))
        answers.append(wa)
    return pipe, state, answers, secs, items


def compare_answers(card, cpu, what, rtols=None):
    """Window answers, card vs CPU: bitwise, or (``rtols``) the sums to
    the tolerances given."""
    exact = ("tick", "ok", "n_sampled", "n_forwarded")
    sums = ("sum", "sum_var", "mean", "mean_var", "histogram")
    if rtols is None:
        exact, rtols = exact + sums, {}
    for wa_k, wa_p in zip(card, cpu):
        for f in exact:
            if not same_bits(getattr(wa_k, f), getattr(wa_p, f)):
                fail(f"{what}: {f} differs between the card and the CPU")
        for f in sums:
            if not torch.isfinite(getattr(wa_k, f).cpu()).all():
                fail(f"{what}: {f} is not finite on the card")
        for f, rtol in rtols.items():
            k, p = getattr(wa_k, f).cpu(), getattr(wa_p, f)
            if not torch.allclose(k, p, rtol=rtol, atol=0.0):
                worst = float(((k - p).abs() / p.abs().clamp_min(1e-30))
                              .max())
                fail(f"{what}: {f} differs from the CPU run by {worst:.3g} "
                     f"relative (> {rtol})")


def compare_queries(pipe, card, cpu, card_state, cpu_state):
    """The tenants' answers and bounds, card vs CPU, and the sketch state:
    bitwise, but for the sketches' bounds (``SKETCH_BOUND_RTOL``)."""
    sketch_cols, exact_cols = [], []
    for o, w, kind in pipe.query_layout().values():
        if kind in SKETCH_KINDS or kind in HH_KINDS:
            sketch_cols.extend(range(o, o + w))
        else:
            exact_cols.extend(range(o, o + w))
    sketch_cols, exact_cols = (torch.tensor(c) for c in (sketch_cols,
                                                         exact_cols))
    for wa_k, wa_p in zip(card, cpu):
        ans_k, ans_p = wa_k.answers.cpu(), wa_p.answers
        bnd_k, bnd_p = wa_k.bounds.cpu(), wa_p.bounds
        if not (torch.isfinite(ans_k).all() and torch.isfinite(bnd_k).all()):
            fail("tenants: answers or bounds are not finite on the card")
        if not same_bits(ans_k, ans_p):
            fail("tenants: answers differ between the card and the CPU")
        if not same_bits(bnd_k[:, exact_cols], bnd_p[:, exact_cols]):
            fail("tenants: CLT or histogram bounds differ between the card "
                 "and the CPU")
        k, p = bnd_k[:, sketch_cols], bnd_p[:, sketch_cols]
        if not torch.allclose(k, p, rtol=SKETCH_BOUND_RTOL, atol=0.0):
            worst = float(((k - p).abs() / p.abs().clamp_min(1e-30)).max())
            fail(f"tenants: sketch bounds differ from the CPU run by "
                 f"{worst:.3g} relative (> {SKETCH_BOUND_RTOL})")

    def leaves(tree):
        if torch.is_tensor(tree):
            return [tree]
        return [x for part in tree for x in leaves(part)]

    k_leaves = leaves(card_state.tree.qstate)
    p_leaves = leaves(cpu_state.tree.qstate)
    if len(k_leaves) != len(p_leaves) or not all(
            same_bits(a, b) for a, b in zip(k_leaves, p_leaves)):
        fail("tenants: the sketch state (qstate) differs between the card "
             "and the CPU")
    return len(k_leaves)


def check_accuracy(pipe, answers, batches):
    """The last window's stream-so-far quantiles, ranked on the exact
    stream, within their rank bound plus the sampling slack; the exact
    most frequent ``hh_item_key`` among ``k8``'s heavy hitters."""
    values = np.concatenate([
        b.values[t, i, :b.counts[t, i]] for b in batches
        for t in range(b.values.shape[0]) for i in range(b.values.shape[1])
    ]).astype(np.float64)
    rows = [row for wa in answers for row in pipe.rows(wa)]
    n_kept = sum(row["n_sampled"] for row in rows)
    last = rows[-1]
    exact = pipe.plan.exact_answers(values)
    lay = pipe.query_layout()
    worst = 0.0
    quantiles = [(f"{t}/{sp.name}", sp.qs) for t in pipe.tenant_names
                 for sp in pipe.plan.plan_for(t).specs
                 if sp.kind == "quantile"]
    for name, qs in quantiles:
        o = lay[name][0]
        for j, target in enumerate(qs):
            got, bound = float(last["answers"][o + j]), float(
                last["bounds"][o + j])
            rank = float((values <= got).mean())
            slack = RANK_SIGMAS * np.sqrt(target * (1 - target) / n_kept)
            if abs(rank - target) > bound + slack:
                fail(f"{name} q={target}: answer {got} has rank {rank:.5f}"
                     f" on the stream, beyond its bound {bound:.5f} + "
                     f"slack {slack:.5f} (exact {exact[o + j]:.4f})")
            worst = max(worst, abs(rank - target) / (bound + slack))
    keys = np.round(values).astype(np.int64)
    uniq, cnt = np.unique(keys, return_counts=True)
    mode = int(uniq[np.argmax(cnt)])
    o, w, _ = lay["k8/heavy"]
    found = [int(k) for k in last["answers"][o:o + w // 2]]
    if mode not in found:
        fail(f"the stream's most frequent key {mode} is not among k8's "
             f"heavy hitters {found}")
    print(f"accuracy on the card: every quantile answer within its rank "
          f"bound + {RANK_SIGMAS:g}-sigma sampling slack (worst at "
          f"{worst:.3f} of it, {n_kept} items kept); most frequent key "
          f"{mode} ({cnt.max()} of {len(values)}) among k8's heavy "
          f"hitters {found}")


def compare_states(card, cpu, what):
    from repro_torch.core.window import TreeState

    for f in TreeState.LEVEL_FIELDS:
        for l, (k, p) in enumerate(zip(getattr(card.tree, f),
                                       getattr(cpu.tree, f))):
            if not same_bits(k, p):
                fail(f"{what}: state {f}[{l}] differs between the card "
                     f"and the CPU")


def report_epochs(what, secs, items, cpu_secs):
    steady = secs[1:] or secs
    rate = sum(items[1:] or items) / sum(steady)
    print(f"{what} ({TICKS} ticks): "
          f"{', '.join(f'{s * 1e3:.1f}' for s in secs)} ms (first includes "
          f"warm-up); steady {1e3 * sum(steady) / len(steady):.1f} ms, "
          f"{rate:.4g} items/s on the card; CPU run "
          f"{1e3 * sum(cpu_secs) / len(cpu_secs):.1f} ms/epoch")


def profile_epoch(what, pipe, state, b):
    """Where a steady epoch's time goes: device time by kernel name from
    the profiler, and the device's busy share of the wall time (the
    profiler's own cost inflates the wall time a little)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run_epoch(state, pipe.default_key, b.values, b.strata, b.counts)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_events:
        print(f"profiled {what}: the profiler saw no device events; device "
              f"busy share not measured")
        return
    by_name: dict[str, list] = {}
    for e in dev_events:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us()
    busy = sum(r[1] for r in by_name.values())
    print(f"profiled {what} ({TICKS} ticks): wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
          f"{len(dev_events)} device events ({len(dev_events) / TICKS:.0f} "
          f"per tick)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    for name, (count, us) in top:
        print(f"  {us / 1e3:8.3f} ms  {count:5d}x  {name[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch as P
    from repro_torch.data import stream as S
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.fused_level_tick import ops as ft, ref as ft_ref
    from repro_torch.kernels.stratified_stats import ops as ss, ref as ss_ref
    from repro_torch.kernels.sketch_update import ops as sk, ref as sk_ref
    from repro_torch.kernels.sample_mask import ops as sm, ref as sm_ref
    from repro_torch.kernels.segment_sum import ops as segsum
    from repro_torch.kernels.segment_sum import ref as segsum_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # 1. Build.
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 2. Each kernel against its plain version.
    qspec = tenant_spec(P)
    qr = P.resolve(qspec)
    root_m = qr.capacities[-1]
    path_shapes = compact_shapes(qr.plan, root_m)
    err = check_kernels(dev)
    err.update(check_sketch_kernels(dev, path_shapes))
    err.update(check_slice3_kernels(dev))
    print(f"max abs differences vs plain: {err}")
    check_neyman_masks(dev, S)

    # 3. The main path on the card, then on the CPU.
    spec = testbed_spec(P)
    r = P.resolve(spec)
    print(f"testbed: fanin {spec.topology.fanin}, capacities "
          f"{r.capacities}, sample sizes {r.sample_sizes}, "
          f"{EPOCHS} epochs x {TICKS} ticks")
    batches = make_ingest(S, EPOCHS, spec.topology.capacity)
    reset_launches()
    pipe, state, answers, secs, items = run_path(P, spec, dev, batches)
    launches = dict(LAUNCHES)
    ticks = EPOCHS * TICKS
    # the root's moments and histogram: 6 ordered float sums a window
    expected = {"fused_level_tick": 2 * ticks, "fused_select": ticks,
                "stratified_stats": ticks, "cms_update": 0,
                "quantile_compact": 0, "sample_mask": 0,
                "segment_sum": 6 * ticks}
    print(f"launches on the tenant-free path: {launches} (expected "
          f"{expected})")
    for name, want in expected.items():
        if launches[name] != want:
            fail(f"{name} launched {launches[name]} times on the "
                 f"tenant-free path, expected {want}")
    _, cpu_state, cpu_answers, cpu_secs, _ = run_path(P, spec, "cpu",
                                                      batches)
    compare_answers(answers, cpu_answers, "whs")
    compare_states(state, cpu_state, "whs")
    print("main path: answers, variances, histograms and state bitwise the "
          "CPU run's")
    rows = [row for wa in answers for row in pipe.rows(wa)]
    approx = sum(row["sum"] for row in rows)
    exact = sum(b.exact_sum for b in batches)
    tel = pipe.telemetry_snapshot(state)
    bound = tel["bound_2sigma"]
    if not np.isfinite(approx) or len(rows) != ticks:
        fail(f"expected {ticks} finite root windows, got {len(rows)}")
    print(f"SUM ~ {approx:.6e} +/- {bound:.3e} (2 sigma), exact "
          f"{exact:.6e}, |err| {abs(approx - exact) / exact:.3e} relative, "
          f"{abs(approx - exact) / bound:.3f} of the 2-sigma bound; "
          f"root kept {tel['levels'][-1]['items_kept']:.0f} of "
          f"{sum(items)} items")
    if abs(approx - exact) > 1.5 * bound:
        fail("SUM outside 3 sigma of the exact sum")

    # The path with tenants: every root window folds the sample into the
    # sketches (2 cms_update, one quantile_compact per level per fold).
    print(f"tenants: k8 + dashboard, {qr.plan.n_out} answer slots, "
          f"{len(qr.plan.core.groups)} slot groups, {Q_EPOCHS} epochs x "
          f"{TICKS} ticks; quantile_compact shapes per window "
          f"{path_shapes}")
    qbatches = make_ingest(S, Q_EPOCHS, qspec.topology.capacity)
    reset_launches()
    qpipe, qstate, qanswers, qsecs, qitems = run_path(P, qspec, dev,
                                                      qbatches)
    q_launches = dict(LAUNCHES)
    qticks = Q_EPOCHS * TICKS
    per_window = {"fused_level_tick": 2, "fused_select": 1,
                  "stratified_stats": 1, "cms_update": 2,
                  "quantile_compact": len(path_shapes), "sample_mask": 0}
    q_expected = {k: v * qticks for k, v in per_window.items()}
    print(f"launches on the path with tenants: {q_launches} (expected "
          f"{q_expected}: per root window {per_window})")
    for name, want in q_expected.items():
        if q_launches[name] != want:
            fail(f"{name} launched {q_launches[name]} times on the path "
                 f"with tenants, expected {want}")
    # the root's 6 and the plan's moments and histogram queries
    if q_launches["segment_sum"] < 6 * qticks:
        fail(f"segment_sum launched {q_launches['segment_sum']} times on "
             f"the path with tenants, expected at least {6 * qticks}")
    _, qcpu_state, qcpu_answers, qcpu_secs, _ = run_path(P, qspec, "cpu",
                                                         qbatches)
    compare_answers(qanswers, qcpu_answers, "tenants")
    compare_states(qstate, qcpu_state, "tenants")
    n_leaves = compare_queries(qpipe, qanswers, qcpu_answers, qstate,
                               qcpu_state)
    print(f"tenants: answers and CLT bounds bitwise the CPU run's, sketch "
          f"bounds within {SKETCH_BOUND_RTOL}; all {n_leaves} sketch state "
          f"leaves bitwise")
    check_accuracy(qpipe, qanswers, qbatches)
    qrows = [row for wa in qanswers for row in qpipe.rows(wa)]
    if len(qrows) != qticks:
        fail(f"expected {qticks} root windows with tenants, got "
             f"{len(qrows)}")
    for tenant, q in (("k8", "quantiles"), ("k8", "heavy"),
                      ("dashboard", "latency_q_recent_ms"),
                      ("dashboard", "hot_latency_keys")):
        print(f"  last window {tenant}/{q}: "
              f"{qpipe.answer(qrows[-1]['answers'], q, tenant=tenant)} "
              f"+/- {qpipe.answer(qrows[-1]['bounds'], q, tenant=tenant)}")

    srs_spec = testbed_spec(P, mode="srs")
    srs_batches = make_ingest(S, 2, srs_spec.topology.capacity)
    srs_pipe, srs_state, srs_ans, srs_secs, srs_items = run_path(
        P, srs_spec, dev, srs_batches)
    _, srs_cpu_state, srs_cpu_ans, _, _ = run_path(P, srs_spec, "cpu",
                                                   srs_batches)
    compare_answers(srs_ans, srs_cpu_ans, "srs", rtols=SRS_RTOL)
    compare_states(srs_state, srs_cpu_state, "srs")
    srs_approx = sum(row["sum"] for wa in srs_ans for row in srs_pipe.rows(wa))
    srs_exact = sum(b.exact_sum for b in srs_batches)
    print(f"srs: SUM ~ {srs_approx:.6e}, exact {srs_exact:.6e}, |err| "
          f"{abs(srs_approx - srs_exact) / srs_exact:.3e} relative; "
          f"agrees with the CPU run (sums within {SRS_RTOL})")

    # The analytics driver: HostTree's level engine and the scan engine
    # with the pallas backend, the neyman allocation on topk, the skewed
    # Poisson mix.
    from repro_torch.launch import analytics as A

    driver = check_driver(A, dev, LAUNCHES, reset_launches)

    # 4. Times, at the main path's shapes: device time from the profiler
    # (what ``ms``, ``plain_ms`` and ``library_ms`` report), and beside it
    # the wrapper loop's time on CUDA events, which includes the host.
    rng = np.random.default_rng(7)
    l0 = [t.to(dev) for t in level_inputs(rng, 4, 11008, 4, 0.73, True)]
    l1 = [t.to(dev) for t in level_inputs(rng, 2, 2200, 4, 1.0, True)]
    root = [t.to(dev) for t in level_inputs(rng, 1, 2200, 4, 1.0, True)]
    size = torch.tensor(1100.0, device=dev)
    root_tick = ft_ref.fused_level_tick(*root, size, 4, 1100)
    root_c, root_res = root_tick[4][0], root_tick[5][0]
    zeros = torch.zeros(2200, device=dev)
    sel_args = (root[3][0], root[1][0], root[2][0], root_res, 4)
    ss_args = (zeros, root[1][0], root[2][0], 4)
    feats = torch.stack([torch.ones_like(zeros), zeros, zeros * zeros], -1)
    seg = torch.where(root[2][0], root[1][0], 4).long()

    def library_ss():
        m = root[2][0][:, None]
        return torch.zeros(5, 3, device=dev).index_add_(
            0, seg, torch.where(m, feats, 0.0))

    def tick(mod, lvl):
        return mod.fused_level_tick(*lvl, size, 4, 1100)

    def bound(nbytes, ops):
        """The least time for the work: its bytes moved once over the HBM
        rate, or its operations over the ALU rate, whichever is larger."""
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / ALU_OPS_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def tick_bytes(n, cap, oc, x):
        # values, strata, priorities (4 B) and valid (1 B) per slot in;
        # keep (1 B) per slot and the [n, oc] buffers out; W/C in and
        # the five [n, X] vectors and n_keep out.
        return (n * cap * 14 + n * oc * 8 + n * x * 8 + 4 + 5 * n * x * 4
                + n * 4)

    def select_passes(c, res, x):
        # Passes over a node's buffer in csrc/fused_level_tick.cu, one
        # operation per slot each, for this data: the counts and the
        # keep-all copy when every reservoir covers its count; else the
        # counts, 31 bisection rounds, the strict count, the strict keeps
        # and one in-order tie walk per stratum.
        return 2 if bool((res >= c).all()) else 34 + x

    def tick_ops(lvl):
        out = tick(ft_ref, lvl)
        n, cap = lvl[0].shape
        # each node's selection passes, then the compaction pass
        return sum(cap * (select_passes(out[4][i], out[5][i], 4) + 1)
                   for i in range(n))

    ms_l0 = device_ms(lambda: tick(ft, l0))
    ms_l1 = device_ms(lambda: tick(ft, l1))
    t = {"fused_level_tick": (
             (ms_l0 + ms_l1) / 2,
             (device_ms(lambda: tick(ft_ref, l0), 5)
              + device_ms(lambda: tick(ft_ref, l1), 5)) / 2,
             None),
         "fused_select": (device_ms(lambda: ft.fused_select(*sel_args)),
                          device_ms(lambda: ft_ref.fused_select(*sel_args),
                                    5),
                          None),
         "stratified_stats": (device_ms(lambda: ss.stratified_stats(*ss_args)),
                              device_ms(lambda: ss_ref.stratified_stats(
                                  *ss_args), 5),
                              device_ms(library_ss))}
    # The sketch kernels at one root window's launches: cms_update at
    # (2200, 4, 1024) and (2200, 4, 256), quantile_compact at each of
    # ``path_shapes``; ms is the mean per launch over the window.
    cms_cases = []
    for width in (1024, 256):
        k, w = cms_inputs(rng, root_m)
        k, w = k.to(dev), w.to(dev)
        flat = (torch.arange(4, device=dev)[:, None] * width
                + sk_ref.hash_buckets(k, 4, width)).reshape(-1)
        cms_cases.append((k, w, width, flat, w.expand(4, -1).reshape(-1)))
    qc_cases = [[a.to(dev) for a in intervals(rng, p, c)]
                for p, c in path_shapes]

    def cms_all(mod):
        for k, w, width, _, _ in cms_cases:
            mod.cms_update(k, w, 4, width)

    def cms_library():
        for _, _, width, flat, wf in cms_cases:
            torch.zeros(4 * width, device=dev).index_add_(0, flat, wf)

    def qc_all(mod):
        for args in qc_cases:
            mod.quantile_compact(*args)

    def qc_library():
        # searchsorted + gather: the same function where the intervals
        # partition [0, W), as the sketch's do.
        for v, _, cumw, tg in qc_cases:
            idx = torch.searchsorted(cumw, tg, right=True)
            torch.where(idx < v.shape[0],
                        v[idx.clamp_max(v.shape[0] - 1)], 0.0)

    n_cms, n_qc = len(cms_cases), len(qc_cases)
    t["cms_update"] = (device_ms(lambda: cms_all(sk)) / n_cms,
                       device_ms(lambda: cms_all(sk_ref), 5) / n_cms,
                       device_ms(cms_library) / n_cms)
    t["quantile_compact"] = (device_ms(lambda: qc_all(sk)) / n_qc,
                             device_ms(lambda: qc_all(sk_ref), 5) / n_qc,
                             device_ms(qc_library) / n_qc)
    wall = {"fused_level_tick": (loop_ms(lambda: tick(ft, l0))
                                 + loop_ms(lambda: tick(ft, l1))) / 2,
            "fused_select": loop_ms(lambda: ft.fused_select(*sel_args)),
            "stratified_stats": loop_ms(lambda: ss.stratified_stats(*ss_args)),
            "cms_update": loop_ms(lambda: cms_all(sk)) / n_cms,
            "quantile_compact": loop_ms(lambda: qc_all(sk)) / n_qc}
    (n0, cap0), (n1, cap1), m = l0[0].shape, l1[0].shape, root[0].shape[1]
    b_l0 = bound(tick_bytes(n0, cap0, 1100, 4), tick_ops(l0))
    b_l1 = bound(tick_bytes(n1, cap1, 1100, 4), tick_ops(l1))
    n_masked = int(root[2][0].sum())
    bounds = {"fused_level_tick": ((b_l0[0] + b_l1[0]) / 2, b_l0[1]),
              "fused_select": bound(m * 10 + 4 * 4,
                                    m * select_passes(root_c, root_res, 4)),
              # count, Σx and Σx² (one multiply, two adds) per masked item
              "stratified_stats": bound(m * 9 + 4 * 12, 4 * n_masked)}
    # cms_update: keys and weights in (8 B per item), the table out; a
    # multiply, a shift and an add per item and depth row.
    cms_b = [bound(root_m * 8 + 4 * width * 4, 3 * 4 * root_m)
             for width in (1024, 256)]
    # quantile_compact: three f32 per slot and the targets in, one f32 per
    # target out; two compares per (slot, target) — the membership rule.
    qc_b = [bound(p * 12 + c * 8, 2 * p * c) for p, c in path_shapes]
    bounds["cms_update"] = (sum(b[0] for b in cms_b) / n_cms,
                            max(cms_b)[1])
    bounds["quantile_compact"] = (sum(b[0] for b in qc_b) / n_qc,
                                  max(qc_b)[1])
    # sample_mask at the pallas path's three launches of a tick; ms is the
    # mean per launch. Bound: u, s (4 B each) and valid (1 B) in, keep
    # (1 B) and w (4 B) out per item, τ and W in; a compare and a select
    # per item. No PyTorch call computes this function: library none.
    sm_cases = [[a.to(dev) for a in mask_inputs(rng, m, x, False)]
                for m, x in MASK_SHAPES]

    def sm_all(mod):
        for args in sm_cases:
            mod.sample_mask(*args)

    sm_each = [device_ms(lambda a=a: sm.sample_mask(*a)) for a in sm_cases]
    t["sample_mask"] = (sum(sm_each) / len(sm_cases),
                        device_ms(lambda: sm_all(sm_ref), 5) / len(sm_cases),
                        None)
    wall["sample_mask"] = loop_ms(lambda: sm_all(sm)) / len(sm_cases)
    sm_b = [bound(m * 14 + x * 8, 2 * m) for m, x in MASK_SHAPES]
    bounds["sample_mask"] = (sum(b[0] for b in sm_b) / len(sm_b),
                             max(sm_b)[1])
    print(f"sample_mask device time per launch at (M, X) {MASK_SHAPES}: "
          f"{[round(x, 5) for x in sm_each]} ms; bounds "
          f"{[round(b[0] * 1e3, 5) for b in sm_b]} us ({sm_b[0][1]})")
    # The ordered segment_sum at its path shapes: a root window's moments
    # (2,200 items, 4 strata) and a neyman level's stds (4 x 11,008).
    # Bound: value and id (8 B) per item in, the sums out; one add per
    # item. Plain = library = index_add_ (float atomics, unordered).
    seg_cases = [[a.to(dev) for a in ordered_inputs(rng, r, mm, 4)]
                 for r, mm in ((1, 2200), (4, 11008))]
    seg_ms = [device_ms(lambda a=a: segsum.segment_sum(*a, 4))
              for a in seg_cases]
    seg_plain = [device_ms(lambda a=a: segsum_ref.segment_sum(*a, 4), 5)
                 for a in seg_cases]
    seg_b = [bound(r * mm * 8 + r * 16, r * mm)
             for r, mm in ((1, 2200), (4, 11008))]
    print(f"segment_sum (ordered, repair kernel, no TPU counterpart): "
          f"device {seg_ms[0]:.4f} ms at [1, 2200] x 4 (6 launches per "
          f"root window), {seg_ms[1]:.4f} ms at [4, 11008] x 4 (neyman, "
          f"level 0); bounds {seg_b[0][0]:.6f}, {seg_b[1][0]:.6f} ms "
          f"({seg_b[0][1]}); plain = library (index_add_, atomics) "
          f"{seg_plain[0]:.4f}, {seg_plain[1]:.4f} ms; launches on the "
          f"level-pallas driver run "
          f"{driver['level pallas'][1]['segment_sum']}; max abs err vs the "
          f"CPU {err['segment_sum']}")
    print(f"fused_level_tick device time per launch: L0 [{n0}, {cap0}] "
          f"{ms_l0:.4f} ms (bound {b_l0[0] * 1e3:.3f} us, {b_l0[1]}), "
          f"L1 [{n1}, {cap1}] {ms_l1:.4f} ms (bound {b_l1[0] * 1e3:.3f} us, "
          f"{b_l1[1]})")
    tiny = torch.zeros(1, device=dev)
    print(f"launch floor (1-element add_): device "
          f"{device_ms(lambda: tiny.add_(1.0), 200):.4f} ms, back-to-back "
          f"loop {loop_ms(lambda: tiny.add_(1.0), 200):.4f} ms")
    per_tick = dict(per_window, sample_mask=3)
    for name, (ms, plain_ms, lib_ms) in t.items():
        print(f"{name}: device {ms:.4f} ms/launch (wrapper loop "
              f"{wall[name]:.4f} ms), {per_tick[name]} launch(es) per tick, "
              f"bound {bounds[name][0]:.6f} ms ({bounds[name][1]}), plain "
              f"device {plain_ms:.4f} ms"
              + (f", library device {lib_ms:.4f} ms" if lib_ms else ""))
    print(f"quantile_compact bounds per launch: "
          f"{[(pc, round(b[0] * 1e3, 4), b[1]) for pc, b in zip(path_shapes, qc_b)]}"
          f" (us)")
    report_epochs("whs epoch", secs, items, cpu_secs)
    report_epochs("whs epoch with tenants", qsecs, qitems, qcpu_secs)
    srs_rate = srs_items[-1] / srs_secs[-1]
    print(f"srs epoch ({TICKS} ticks): "
          f"{', '.join(f'{s * 1e3:.1f}' for s in srs_secs)} ms (first "
          f"includes warm-up); steady {srs_rate:.4g} items/s on the card")
    profile_epoch("whs epoch", pipe, state, batches[-1])
    profile_epoch("whs epoch with tenants", qpipe, qstate, qbatches[-1])
    for name, (rep_, _) in driver.items():
        print(f"driver items/s, {name}: {rep_['throughput_items_s']:.4g} "
              f"({DRIVER_TICKS} ticks, wall {rep_['wall_s'] * 1e3:.1f} ms, "
              f"level time {[round(x * 1e3, 2) for x in rep_['level_time_s']]}"
              f" ms, {rep_['dispatches']} dispatches)")

    # 5. Result lines.
    # launches: the tenant path's for the five kernels on it, the pallas
    # driver run's for sample_mask.
    path_launches = dict(q_launches,
                         sample_mask=driver["level pallas"][1]["sample_mask"])
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": path_launches[name],
                "max_abs_err": err[name], "ms": t[name][0],
                "plain_ms": t[name][1], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1], "library_ms": t[name][2]}
               for name in REPLACES]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
