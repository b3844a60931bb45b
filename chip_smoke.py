"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives ``src/repro_torch`` only (nothing of JAX or of the JAX package):

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc`` for sm_90a,
   one ``nvcc`` per source, all at once; counts the bf16 flash kernel's
   ``HGMMA`` and ``UTMALDG`` instructions in its SASS (``cuobjdump``);
2. holds each kernel against its plain PyTorch version on the same
   inputs — the sampler kernels at the paper testbed's shapes, at 32
   strata and above (64 per node), saturated or not, front-packed or
   not, with ``out_capacity`` below the keep count, with exact f32
   priority ties, for the fair, proportional and neyman allocations;
   and, with a stratum whose priorities are all equal and one without a
   valid item, at both sides of every change of the radix digit's width
   up to 4,096 strata, on caps that the cluster of CTAs does not divide
   or that are smaller than it, at ``n_eff = 1`` and with neyman above 32
   strata; ``cms_update`` at the tenants' shapes and the reference test's, with
   no items, one key for every item, depth 6 and widths 1 to 65,536;
   ``quantile_compact`` at every (slots, targets) shape one root window
   of the tenant path launches and at slot counts that are not a
   multiple of its tile, and on intervals built as the sketch builds them
   (``blocked_cumsum``: targets in two slots, a lone ``-0.0``, up to
   65,536 slots and 640 targets); ``sample_mask`` at the three shapes of the
   ``pallas`` path, with ties and sentinels, and at M = 1, 333, 44,033;
   the ordered ``segment_sum`` against the CPU's ``index_add_`` on sums
   whose value depends on their order, also on a row longer than one
   staging chunk, one segment holding every item, 1,500 segments, no id
   in range and -0.0, inf and NaN (NaN compared as NaN);
   ``stratified_stats`` at the root's and the ``pallas`` backend's shapes,
   on both sides of its change of layout (24 and 25 strata) and at 4,096
   strata; one call of ``segment_sum`` and of
   ``stratified_stats`` is one launch of its kernel and no other device
   operation (a profiler trace); ``flash_attention`` at the
   reference test's shapes in f32 and bf16, at SmolLM-135M's prefill, at
   Qwen3-4B's heads and, in bf16, over S 16 to 2,048, head dims 32, 64
   and 128 and GQA ratios 1, 3 and 4, against its plain version
   (``FLASH_F32_TOL``, or one bf16 ulp) and the S×S oracle
   (``ORACLE_TOL``). Everything else
   agrees bitwise except ``stratified_stats``' Σx and Σx², held to
   ``SUMS_RTOL`` (a fixed-order block reduction, not item order). Then
   the neyman reservoirs and masks
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
   exact sum, launching ``sample_mask`` 3 times a tick on ``pallas``.
   Then the model zoo's serving half: SmolLM-135M's prefill at full
   width (bf16, B 8, S 2048) through ``make_prefill_step`` with the
   flash kernel, launched once per layer (30), against the xla path, and
   an f32 copy (B 1, S 512) card against CPU; the serve CLI
   (``repro_torch.launch.serve``) at the reference's defaults, and one
   f32 batch whose greedy tokens must be the CPU's;
4. times each kernel at the main path's shapes beside its bound, its
   plain version and (where one exists) one PyTorch call computing the
   same function, as device time from the profiler's CUDA trace (and
   prints ``cms_update``'s, ``quantile_compact``'s and the bf16
   ``flash_attention``'s ratio to that call, and ``fused_level_tick``'s
   and ``fused_select``'s times, beside their earlier designs';
   ``cms_update`` at (32000, 4, 8192), the
   bf16 kernel at head dim 32 and the f32 kernel at (1, 9, 3, 512, 64)
   too; ``segment_sum`` at its three path shapes beside its serial floor,
   the longest segment times one dependent f32 add as
   ``tools/fadd_chain.py`` measures it, and ``stratified_stats`` at its
   four path shapes and at 4,096 strata, each beside its earlier
   design's time), times
   the WHS epochs with and without tenants and the SRS epochs, profiles
   one epoch of each WHS path, prints the analytics runs' items/s per
   engine and backend, and the prefill's ms per forward and tokens/s;
5. prints a ``kernels`` JSON line and, last, the ``ok`` JSON line.

It exits non-zero, before printing any result, without a CUDA device or
without the repository's ``src`` beside it.
"""
from __future__ import annotations

import json
import statistics
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
# SmolLM-135M's prefill: B 8 at its published context length (HF config
# max_position_embeddings 2048). The reference's prefill_32k shape
# (B 32, S 32,768) is cut: its bf16 logits alone would be 103 GB.
PREFILL_BATCH = 8
PREFILL_SEQ = 2048
# The pallas and xla prefill paths in bf16 round at different points (p
# before P·V against the probabilities after normalisation) in each of 30
# layers: the sound kernel reads argmax agreement 0.9516 and max abs
# 0.1445 against a largest logit of 6.0. Planted faults
# (tools/flash_planted_faults.py) read 0.0001 and 8.80 (kv head h % Hkv)
# and 0.3741 and 5.59 (causal mask admitting one future token) on an
# H100; the limits lie between. The tight check is the f32 copy (B 1,
# S 512), card pallas, card xla and CPU, whose differences are f32 sums
# in other orders through 30 layers: within 1e-3 of the largest logit.
PREFILL_BF16_AGREE = 0.8
PREFILL_BF16_REL = 0.1
PREFILL_F32_REL = 1e-3
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
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:70",
    # not a TPU kernel: the card's counterpart of the reference's XLA
    # scatter-add, float sums in item order
    "segment_sum": "src/repro/core/sampling.py:70",
}
SOURCES = {
    "sample_mask": "src/repro_torch/csrc/sample_mask.cu",
    "fused_level_tick": "src/repro_torch/csrc/fused_level_tick.cu",
    "fused_select": "src/repro_torch/csrc/fused_level_tick.cu",
    "stratified_stats": "src/repro_torch/csrc/stratified_stats.cu",
    "cms_update": "src/repro_torch/csrc/sketch_update.cu",
    "quantile_compact": "src/repro_torch/csrc/sketch_update.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "segment_sum": "src/repro_torch/csrc/segment_sum.cu",
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


PADS = 8     # spin kernels in a pad, the marker between counted runs
PAD_GAP_US = 1000.0   # spins of one pad lie closer; pads lie 10 ms apart


def _pad() -> None:
    for _ in range(PADS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.01)


def traced(fn, *calls: int):
    """``(windows, walls)``: one profiler CUDA trace of runs of
    ``calls[i]`` calls of ``fn``, each run between two pads (a cluster of
    spin kernels and a pause). ``windows`` holds the device events
    between each two consecutive pads seen, in order; ``walls`` each
    run's wall seconds. On the card's machines a trace can lose device
    events near its start and its end (the first launch of a kernel from
    a library loaded outside PyTorch; often the first pad of a trace;
    in a long process, whole short traces), and can carry one over from
    the trace before it. So the
    runs follow two uncounted calls, each between pads, and a last pad
    closes the trace: when a pad is lost, the windows no longer match
    the runs, which the caller sees from their event counts."""
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            _pad()
            fn()
        _pad()
        for n in calls:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            _pad()
        _pad()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    pads: list[list[float]] = []
    for r in sorted((e.time_range for e in ev if "spin_kernel" in e.name),
                    key=lambda r: r.start):
        if pads and r.start - pads[-1][1] < PAD_GAP_US:
            pads[-1][1] = max(pads[-1][1], r.end)
        else:
            pads.append([r.start, r.end])
    rest = [e for e in ev if "spin_kernel" not in e.name]
    return [[e for e in rest if lo[1] <= e.time_range.start
             and e.time_range.end <= hi[0]]
            for lo, hi in zip(pads, pads[1:])], walls


TRACES = 5   # traces per device time; the time is their median
# kernel → (per-trace ms, traces rejected, CUDA-event ms or None) of each
# timing
SPREAD: dict[str, list] = {}


def device_ms(fn, iters: int = 20, name: str | None = None) -> float:
    """Device time of one call: the summed durations of the device
    operations it launches, from profiler CUDA traces of a run of
    ``iters`` calls and one of ``2 * iters`` after a warm-up; the median
    over ``TRACES`` traces. A trace counts only if two consecutive
    windows hold ``n`` and ``2n`` events, ``n`` a nonzero multiple of
    ``iters`` (a trace that lost launches or a pad fails this); up to
    ``2 * TRACES`` are taken. If none counts, the time comes from CUDA
    events around the calls instead, which for a call shorter than its
    host issue time is the issue time, and says so. With ``name``, the
    per-trace times and the rejected traces' count are kept in
    ``SPREAD[name]``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen, times = [], []
    for _ in range(2 * TRACES):
        windows, _ = traced(fn, iters, 2 * iters)
        for one, two in zip(windows, windows[1:]):
            if one and len(one) % iters == 0 and len(two) == 2 * len(one):
                us = sum(e.time_range.elapsed_us() for e in one + two)
                times.append(us / (3 * iters) / 1e3)
                break
        else:
            seen.append([len(w) for w in windows])
        if len(times) == TRACES:
            break
    if seen and name:
        print(f"device_ms {name}: events between pads in the rejected "
              f"traces: {seen}")
    if times:
        if name:
            SPREAD.setdefault(name, []).append((times, len(seen), None))
        return statistics.median(times)
    ms = loop_ms(fn, iters)
    print(f"device_ms: no trace held runs of {iters} and {2 * iters} calls "
          f"(events between pads: {seen}); CUDA events give {ms:.4f} ms "
          f"per call")
    if name:
        SPREAD.setdefault(name, []).append(([], len(seen), ms))
    return ms


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
        (3, 8192, 32, 1500, 1200, 0.95, False, "fair", True),  # 32: ballots
        (3, 8192, 32, 1500, 1500, 1.0, True, "neyman", False),
        (2, 8192, 32, 2000, 2000, 0.9, True, "proportional", True),
        (2, 1024, 4, 0, 64, 1.0, True, "fair", False),         # zero budget
        # above 32 strata per node: state in dynamic shared memory
        (1, 11008, 64, 1100, 1100, 0.73, True, "fair", False),
        (2, 8192, 64, 1500, 1200, 0.9, False, "neyman", True),
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
    # The cluster design's edges: X on both sides of every change of the
    # radix digit's width and 4,096, caps that the cluster does not divide
    # or that are smaller than it, n_eff = 1 (budget = X), neyman above 32
    # strata; in each, a stratum whose valid priorities are all equal and
    # one without a valid item.
    lib = ft._lib()
    widths = [ft.digit_bits(x) for x in range(1, ft.MAX_STRATA + 1)]
    if [lib.fused_level_tick_digit_bits(x)
            for x in range(1, ft.MAX_STRATA + 1)] != widths:
        fail("fused_level_tick's digit widths differ from the wrapper's")
    changes = [x for x in range(2, ft.MAX_STRATA + 1)
               if widths[x - 1] != widths[x - 2]]
    edge = [(1, 9000, x, 3000, 2000, "fair", x % 2 == 0)
            for x in sorted({y for c in changes for y in (c - 1, c)})
            + [ft.MAX_STRATA]]
    edge += [(3, 5, 2, 2, 5, "fair", False), (4, 1, 1, 1, 1, "fair", False),
             (2, 7, 3, 4, 3, "neyman", True),
             (3, 2203, 4, 4, 64, "fair", True),
             (2, 4099, 8, 8, 8, "proportional", False),
             (2, 4096, 100, 900, 900, "neyman", True),
             (1, 8192, 4096, 5000, 4000, "neyman", False)]
    for n, cap, x, budget, oc, alloc, ties in edge:
        cpu = degenerate(level_inputs(rng, n, cap, x, 0.9, False, ties), x)
        size = torch.tensor(float(budget))
        plain = ft_ref.fused_level_tick(*cpu, size, x, oc, allocation=alloc)
        card = ft.fused_level_tick(*(t.to(dev) for t in cpu), size.to(dev),
                                   x, oc, allocation=alloc)
        torch.cuda.synchronize()
        for name, p, k in zip(names, plain, card):
            if not same_bits(p, k):
                fail(f"fused_level_tick {name} differs from the plain "
                     f"version at n={n} cap={cap} X={x} budget={budget} "
                     f"out_capacity={oc} {alloc} ties={ties} (edge strata)")
        for res in (plain[5][0], torch.ones(x)):
            p = ft_ref.fused_select(cpu[3][0], cpu[1][0], cpu[2][0], res, x)
            k = ft.fused_select(cpu[3][0].to(dev), cpu[1][0].to(dev),
                                cpu[2][0].to(dev), res.to(dev), x)
            if not same_bits(p, k):
                fail(f"fused_select differs from the plain version at "
                     f"M={cap} X={x} ties={ties} (edge strata)")
    print(f"fused_level_tick and fused_select vs plain with a stratum of "
          f"equal priorities and one without a valid item, at (n, cap, X, "
          f"budget, out_capacity, allocation, ties) = {edge} (digit width "
          f"changes at X = {changes}): bitwise equal")
    return err


def degenerate(arrs, x):
    """Stratum 0's valid priorities all equal, stratum ``x - 1`` (when
    ``x > 1``) without a valid item."""
    vals, strata, valid, u, w_in, c_in = (a.clone() for a in arrs)
    u[strata == 0] = 0.37
    if x > 1:
        valid[strata == x - 1] = False
    return [vals, strata, valid, u, w_in, c_in]


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


def sketch_intervals(rng, p, c):
    """Intervals as the sketch builds them: ``cumw`` by ``blocked_cumsum``
    (the reference's blocked scan, which can fall by an ulp at a block
    boundary), ``cumw_prev`` shifted by one, weights with zeros. Targets
    sit in the descents (a target there lies in two slots; at least one
    must) and on a lone ``-0.0`` value; the rest are equi-spaced, the last
    at the total (no slot)."""
    from repro_torch.query.sketches import blocked_cumsum

    v = np.sort(rng.normal(0, 30, p)).astype(np.float32)
    w = (rng.uniform(0.5, 3.0, p) * rng.choice([1.0, 7.0, 1000.0], p)
         ).astype(np.float32)
    w[rng.random(p) < 0.3] = 0.0
    cumw = blocked_cumsum(torch.from_numpy(w)).numpy()
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
    if not (hits == 2).any() or hits[-2] != 1:
        fail(f"sketch intervals at P={p} C={c}: no target hits two slots, "
             f"or the -0.0 slot is not hit alone (hits {np.bincount(hits)})")
    return [torch.from_numpy(a) for a in (v, prev, cumw, t)], hits


def cms_inputs(rng, m):
    keys = rng.integers(-2**31, 2**31, m, dtype=np.int64).astype(np.int32)
    keys[: m // 3] = rng.integers(0, 50, m // 3)    # heavy keys
    w = rng.uniform(0.1, 40.0, m).astype(np.float32)
    w[rng.random(m) < 0.2] = 0.0
    return torch.from_numpy(keys), torch.from_numpy(w)


# (M, depth, width, every item on one key): the tenants' two launches, the
# reference test's shapes, no items, width 1, one-key streams, depth 6,
# widths to 65,536 and more items than one staged tile.
CMS_SHAPES = ((2200, 4, 1024, False), (2200, 4, 256, False),
              (512, 4, 256, False), (4096, 2, 1024, False),
              (5000, 6, 128, False), (32000, 4, 8192, False),
              (0, 4, 1024, False), (77, 1, 1, False), (2200, 4, 1024, True),
              (2200, 4, 256, True), (5000, 1, 1, True),
              (4096, 6, 65536, True), (32000, 6, 65536, False),
              (9000, 6, 512, False))


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
    for m, depth, width, one_key in CMS_SHAPES:
        k, w = cms_inputs(rng, m)
        if one_key:
            k[:] = k[0] if m else 0
        plain = sk_ref.cms_update(k, w, depth, width)
        card = sk.cms_update(k.to(dev), w.to(dev), depth, width)
        torch.cuda.synchronize()
        if not same_bits(plain, card):
            fail(f"cms_update differs from the plain version at M={m} "
                 f"depth={depth} width={width} one key={one_key}")
        err["cms_update"] = max(err["cms_update"], max_abs(plain, card))
    print(f"cms_update vs plain at (M, depth, width, one key) = "
          f"{CMS_SHAPES}: bitwise equal")
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
    doubles = []
    for p, c in SKETCH_QC_SHAPES:
        args, hits = sketch_intervals(rng, p, c)
        plain = sk_ref.quantile_compact(*args)
        card = sk.quantile_compact(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        if not same_bits(plain, card):
            fail(f"quantile_compact differs from the plain version on "
                 f"blocked-cumsum intervals at P={p} C={c}")
        err["quantile_compact"] = max(err["quantile_compact"],
                                      max_abs(plain, card))
        doubles.append(int((hits == 2).sum()))
    print(f"quantile_compact vs plain on blocked-cumsum intervals at (P, C) "
          f"= {SKETCH_QC_SHAPES}: bitwise equal, with {doubles} targets in "
          f"two slots and a lone -0.0 hit each")
    return err


# (P, C) of the blocked-cumsum cases: past the scan's recursion (P > 256),
# more than one block of targets (C > 256), up to 65,536 slots.
SKETCH_QC_SHAPES = ((1025, 64), (2456, 128), (5000, 300), (65536, 640))


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
    for case, vals, ids, x in segment_edge_cases(rng):
        for dt in (torch.int32, torch.int64):
            plain = seg_ref.segment_sum(vals, ids.to(dt), x)
            card = seg.segment_sum(vals.to(dev), ids.to(dt).to(dev), x)
            torch.cuda.synchronize()
            if not same_sums(plain, card):
                fail(f"segment_sum differs from the CPU's item-order sums "
                     f"on {case} ({tuple(vals.shape)} x {x}, ids {dt})")
    print("segment_sum vs the CPU on a row longer than one chunk, one "
          "segment holding every item, 1,500 segments, no id in range, "
          "-0.0/inf/NaN, int32 and int64 ids: bitwise equal (NaN as NaN)")
    return err


def same_sums(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise, with NaN compared as NaN (the card's NaN has another
    payload and sign than the CPU's)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and same_bits(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


def segment_edge_cases(rng):
    """(name, values, int64 ids, S) of the redesigned ``segment_sum``'s
    edges: a row longer than one staging chunk, the longest chain (one
    segment holds every item), more segments than the block's threads,
    no id in [0, S), and -0.0, inf and NaN."""
    v, i = ordered_inputs(rng, 1, 100_003, 4)
    yield "a row longer than one chunk", v, i.long(), 4
    v, _ = ordered_inputs(rng, 2, 20_000, 3)
    yield "one segment holding every item", v, torch.ones(
        (2, 20_000), dtype=torch.int64), 3
    v, i = ordered_inputs(rng, 2, 30_000, 1_500)
    yield "1,500 segments", v, i.long(), 1_500
    v, i = ordered_inputs(rng, 2, 5_000, 8)
    i = i.long()
    yield "no id in range", v, torch.where(i % 2 == 0, i.abs() + 8,
                                            -1 - i.abs()), 8
    v, i = ordered_inputs(rng, 2, 9_000, 8)
    i = torch.where(i.long() < 4, 4, i.long())
    v[:, 0], i[:, 0] = -0.0, 0              # segment 0: -0.0 alone
    v[:, 1], i[:, 1] = float("inf"), 1
    v[:, 2], v[:, 3], i[:, 2:4] = float("inf"), float("-inf"), 2
    v[:, 5], i[:, 5] = float("nan"), 3
    yield "-0.0, inf and NaN", v, i, 8


def one_kernel_a_call(fn, kernel: str, calls: int = 10) -> None:
    """The device operations of ``calls`` calls of ``fn`` in one profiler
    trace (``traced``; up to three traces where one loses events). Fails
    unless they are ``calls`` launches of ``kernel`` and nothing else (no
    fill, no copy, no second kernel)."""
    for _ in range(3):
        windows, _ = traced(fn, calls)
        names = [[e.name for e in w] for w in windows]
        if any(len(w) == calls for w in names):
            break
    if any(kernel not in n for w in names for n in w) or not any(
            len(w) == calls for w in names):
        fail(f"{kernel}: {calls} calls did not run as {calls} launches of "
             f"its kernel alone: {names}")


def check_stats_and_launches(dev) -> dict:
    """Phase 2, the redesigned ``stratified_stats`` at the path's shapes
    (the root's counts on ``pallas_fused`` and the ``pallas`` backend's
    three launches a tick) and at 4,096 strata: counts bitwise, sums
    within ``SUMS_RTOL``, the path's zero-valued call bitwise; then one
    call of it and of ``segment_sum`` is one launch of its kernel and no
    other device operation. Returns the largest absolute difference."""
    from repro_torch.kernels.segment_sum import ops as seg
    from repro_torch.kernels.stratified_stats import ops as ss, ref as ss_ref

    rng = np.random.default_rng(17)
    err = 0.0
    # and both sides of the kernel's change of layout (24 and 25 strata)
    shapes = ((2_200, 4),) + MASK_SHAPES + ((40_000, 24), (9_000, 25),
                                            (3_000, 4_096))
    for m, x in shapes:
        _, strata, valid, _, _ = mask_inputs(rng, m, x, False)
        vals = torch.from_numpy(rng.normal(100, 25, m).astype(np.float32))
        for v in (vals, torch.zeros(m)):
            p = ss_ref.stratified_stats(v, strata, valid, x)
            k = ss.stratified_stats(v.to(dev), strata.to(dev), valid.to(dev),
                                    x).cpu()
            if not same_bits(p[:, 0], k[:, 0]):
                fail(f"stratified_stats counts differ at M={m} X={x}")
            if not torch.allclose(k[:, 1:], p[:, 1:], rtol=SUMS_RTOL,
                                  atol=0.0):
                fail(f"stratified_stats sums beyond rtol {SUMS_RTOL} at "
                     f"M={m} X={x}")
            err = max(err, max_abs(p, k))
    print(f"stratified_stats vs plain at (M, X) = {shapes}: counts bitwise, "
          f"sums within {SUMS_RTOL}")
    _, strata, valid, _, _ = (a.to(dev) for a in mask_inputs(
        rng, 44_032, 16, False))
    z = torch.zeros(44_032, device=dev)
    one_kernel_a_call(lambda: ss.stratified_stats(z, strata, valid, 16),
                      "stratified_stats")
    vals, ids = (a.to(dev) for a in ordered_inputs(rng, 4, 11_008, 4))
    one_kernel_a_call(lambda: seg.segment_sum(vals, ids, 4), "segment_sum")
    print("segment_sum and stratified_stats: each call one launch of its "
          "kernel, no fill, no second launch (profiler trace)")
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
                "quantile_compact": 0, "flash_attention": 0}
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


# ------------------------------------------------------- flash attention --
# (B, Hq, Hkv, S, D): the reference test's shapes, then SmolLM-135M's
# prefill (the main path's launch) and Qwen3-4B's heads at S 4096.
FLASH_SHAPES = ((1, 2, 1, 128, 64), (2, 4, 2, 256, 64), (1, 8, 2, 256, 128),
                (2, 3, 3, 128, 32))
SMOLLM_ATTN = (8, 9, 3, 2048, 64)
QWEN3_ATTN = (1, 32, 8, 4096, 128)
# The bf16 (tensor-core) kernel over S from one short block to 16 tiles,
# each head dim and query heads per kv head 1, 3 and 4.
FLASH_BF16_GRID = tuple((1, 2 * g, 2, s, d) for s in (16, 64, 128, 256, 2048)
                        for d in (32, 64, 128) for g in (1, 3, 4))
# The earlier designs' kernel time over the library call's at the same
# shapes (PERF.md's kernel table, NVIDIA H100 80GB HBM3, 700.00 W):
# cms_update with one thread a bucket against index_add_, flash_attention
# on the CUDA cores against SDPA at SmolLM-135M's and Qwen3-4B's shapes,
# quantile_compact with one thread a target against searchsorted + gather.
EARLIER_RATIO = {"cms_update": 17.3, SMOLLM_ATTN: 16.5, QWEN3_ATTN: 24.3,
                 "quantile_compact": 5.3}
# The earlier designs' device ms per launch at the main path's shapes (the
# same table): quantile_compact with one thread a target walking every
# slot, fused_level_tick (level 0, level 1) and fused_select with one
# block a node and tau by 31 bisection rounds; segment_sum with one warp a
# (row, segment) walking the row, stratified_stats in two launches (block
# partials, then a pass in block order) walking the strata 32 at a time
# (tools/kernel_ab.py on an NVIDIA H100 80GB HBM3, 700.00 W).
EARLIER_MS = {"quantile_compact": 0.0477, "fused_level_tick L0": 0.2171,
              "fused_level_tick L1": 0.0673, "fused_select": 0.0622,
              "segment_sum [1, 2200] x 4": 0.00960,
              "segment_sum [4, 11008] x 4": 0.04038,
              "segment_sum [1, 2200] x 32 int64": 0.00826,
              "stratified_stats (2200, 4)": 0.00461,
              "stratified_stats (44032, 16)": 0.00783,
              "stratified_stats (4400, 8)": 0.00550,
              "stratified_stats (3000, 4096)": 0.716}
F32_ATTN = (1, 9, 3, 512, 64)
# Kernel vs plain version: f32 only the order of the f32 sums and exp's
# last bit differ; bf16 both round p at the same values (same kv blocks,
# same running max), so an output may land one bf16 ulp away, at its own
# magnitude or, near zero, at the output's RMS magnitude.
FLASH_F32_TOL = 1e-5
# Against the S×S oracle, which rounds elsewhere: the reference test's
# tolerances (tests/test_kernels.py).
ORACLE_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
TC_FLOPS = 989e12    # H100 SXM data sheet: bf16 dense, tensor cores


def flash_inputs(shape, dtype, seed, dev):
    b, hq, hkv, s, d = shape
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(sh, generator=g).to(dtype).to(dev)
            for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers (8 significant bits) at |x|."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def flash_agrees(got: torch.Tensor, want: torch.Tensor) -> bool:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return False
    if want.shape != got.shape:
        return False
    err = (got - want).abs()
    rms = want.pow(2).mean().sqrt()
    return bool((err <= torch.maximum(bf16_ulp(want), bf16_ulp(rms))).all())


def flash_ops(shape):
    """Operations of one causal launch: 2 multiply-adds per (row, column ≤
    row, dim), for Q·Kᵀ and for P·V."""
    b, hq, hkv, s, d = shape
    return 2 * 2 * b * hq * (s * (s + 1) // 2) * d


def flash_bound(shape):
    """(ms, by): the causal work's operations over the tensor cores' bf16
    rate — 2 multiply-adds per (row, column ≤ row, dim) for Q·Kᵀ and P·V —
    or q, k, v read and o written once over the HBM rate."""
    b, hq, hkv, s, d = shape
    ops = flash_ops(shape)
    nbytes = 2 * b * s * d * (2 * hq + 2 * hkv)
    t_o, t_b = ops / TC_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def check_flash(dev) -> float:
    """Phase 2: ``flash_attention`` against its plain version and the
    S×S oracle. Returns the largest absolute difference from the plain
    version."""
    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref

    worst = 0.0
    cases = [(sh, dt) for sh in FLASH_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(SMOLLM_ATTN, torch.bfloat16), (QWEN3_ATTN, torch.bfloat16),
              (F32_ATTN, torch.float32)]
    cases += [(sh, torch.bfloat16) for sh in FLASH_BF16_GRID]
    for i, (shape, dt) in enumerate(cases):
        q, k, v = flash_inputs(shape, dt, i, dev)
        plain = fa_ref.flash_attention(q, k, v)
        card = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        if dt == torch.float32:
            ok = torch.allclose(card, plain, rtol=FLASH_F32_TOL,
                                atol=FLASH_F32_TOL)
        else:
            ok = flash_agrees(card, plain)
        if not ok:
            fail(f"flash_attention differs from its plain version at "
                 f"{shape} {dt}: max abs {max_abs(card, plain)}")
        oracle = fa_ref.attention(q, k, v)
        tol = ORACLE_TOL[dt]
        if not torch.allclose(card.float(), oracle.float(), rtol=tol,
                              atol=tol):
            fail(f"flash_attention differs from the S×S oracle at {shape} "
                 f"{dt} beyond {tol}: max abs {max_abs(card, oracle)}")
        worst = max(worst, max_abs(card, plain))
        if shape not in FLASH_BF16_GRID:
            print(f"flash_attention vs plain at {shape} {dt}: max abs "
                  f"{max_abs(card, plain):.3e}; vs oracle "
                  f"{max_abs(card, oracle):.3e}")
        del q, k, v, plain, card, oracle
    print(f"flash_attention bf16 over (B, Hq, Hkv, S, D) = "
          f"{FLASH_BF16_GRID}: within one bf16 ulp of the plain version and "
          f"{ORACLE_TOL[torch.bfloat16]} of the oracle")
    return worst


def run_prefill(dev, LAUNCHES, reset_launches) -> dict:
    """Phase 3, the model path: SmolLM-135M's prefill at full width (30
    layers, bf16, random weights from seed 0), B ``PREFILL_BATCH`` × S
    ``PREFILL_SEQ``, through ``make_prefill_step`` with the flash kernel,
    against the xla path on the card; then an f32 copy at B 1, S 512 on
    the card (pallas and xla) and on the CPU."""
    import copy
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.optim import train_step as T

    cfg = dataclasses.replace(registry.get_config("smollm-135m"),
                              attention_impl="pallas")
    xcfg = dataclasses.replace(cfg, attention_impl="xla")
    params = M.init_params(cfg, seed=0, device=dev)
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ),
                         generator=g).to(dev)
    pallas, xla = T.make_prefill_step(cfg), T.make_prefill_step(xcfg)
    pallas(params, {"tokens": toks[:, :128]})       # warm-up
    torch.cuda.synchronize()
    reset_launches()
    logits = pallas(params, {"tokens": toks})
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention launched {launches['flash_attention']} "
             f"times in one SmolLM-135M prefill, expected {cfg.num_layers}")
    want_shape = (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab_size)
    if tuple(logits.shape) != want_shape or logits.dtype != torch.bfloat16:
        fail(f"prefill logits {tuple(logits.shape)} {logits.dtype}, "
             f"expected {want_shape} bf16")
    if not bool(torch.isfinite(logits).all()):
        fail("prefill logits are not finite")
    xlogits = xla(params, {"tokens": toks})
    diff = max_abs(logits, xlogits)
    scale = float(xlogits.float().abs().max())
    agree = float((logits.argmax(-1) == xlogits.argmax(-1)).float().mean())
    print(f"SmolLM-135M prefill B {PREFILL_BATCH} S {PREFILL_SEQ} bf16: "
          f"{launches['flash_attention']} flash_attention launches; pallas "
          f"vs xla path max abs {diff:.4f} (max |logit| {scale:.3f}), "
          f"argmax agreement {agree:.4f}")
    if agree < PREFILL_BF16_AGREE or diff > PREFILL_BF16_REL * scale:
        fail(f"bf16 prefill: pallas and xla paths disagree (argmax "
             f"agreement {agree:.4f} < {PREFILL_BF16_AGREE} or max abs "
             f"{diff:.4f} > {PREFILL_BF16_REL} x {scale:.3f})")
    del xlogits

    def forward_ms(step, reps=5):
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step(params, {"tokens": toks})
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    ms_p, ms_x = forward_ms(pallas), forward_ms(xla)
    profile_call("SmolLM-135M prefill forward (pallas)",
                 lambda: pallas(params, {"tokens": toks}), cfg.num_layers,
                 "layer")
    n_tok = PREFILL_BATCH * PREFILL_SEQ
    print(f"SmolLM-135M prefill: pallas path {ms_p:.2f} ms per forward "
          f"({n_tok / ms_p * 1e3:.4g} tokens/s), xla path {ms_x:.2f} ms "
          f"({n_tok / ms_x * 1e3:.4g} tokens/s)")
    del params, logits
    torch.cuda.empty_cache()

    # f32: pallas and xla on the card, the plain version on the CPU.
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
    cpu_params = M.init_params(cfg32, seed=0, device="cpu")
    card_params = copy.deepcopy(cpu_params).to(dev)
    t32 = torch.randint(0, cfg.vocab_size, (1, 512), generator=g)
    cpu = T.make_prefill_step(cfg32)(cpu_params, {"tokens": t32})
    card = T.make_prefill_step(cfg32)(card_params, {"tokens": t32.to(dev)})
    cardx = T.make_prefill_step(
        dataclasses.replace(cfg32, attention_impl="xla"))(
        card_params, {"tokens": t32.to(dev)})
    tol = PREFILL_F32_REL * float(cpu.abs().max())
    errs = {"card pallas vs cpu": max_abs(card, cpu),
            "card xla vs cpu": max_abs(cardx, cpu),
            "card pallas vs card xla": max_abs(card, cardx)}
    print(f"SmolLM-135M prefill f32 B 1 S 512: max abs {errs} (tolerance "
          f"{tol:.3e} = {PREFILL_F32_REL} x max |logit|)")
    if max(errs.values()) > tol:
        fail(f"f32 prefill: card and CPU disagree beyond {tol:.3e}: {errs}")
    return {"launches": launches, "ms_pallas": ms_p, "ms_xla": ms_x,
            "diff": diff, "agree": agree}


def run_serve(dev, LAUNCHES, reset_launches) -> dict:
    """Phase 3, the serve CLI at the reference's defaults on the card
    (SmolLM-135M, 64 requests in batches of 8, prompt 64, decode 16), then
    one batch (8 × prompt 16, decode 4) in f32 against the CPU: the same
    greedy tokens."""
    import copy
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    reset_launches()
    t0 = time.perf_counter()
    mean, exact = serve.main(["--arch", "smollm-135m"])
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    print(f"serve CLI on the card: {secs:.2f} s; launches {launches}")
    if not np.isfinite(mean) or launches["quantile_compact"] < 1:
        fail(f"serve CLI: mean latency {mean}, quantile_compact launched "
             f"{launches['quantile_compact']} times")
    cfg = dataclasses.replace(registry.get_config("smollm-135m"),
                              param_dtype=torch.float32)
    cpu_params = M.init_params(cfg, seed=0, device="cpu")
    card_params = copy.deepcopy(cpu_params).to(dev)
    g = torch.Generator().manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (8, 16), generator=g)
    want = serve.serve_batch(cfg, cpu_params, toks, 4)
    got = serve.serve_batch(cfg, card_params, toks.to(dev), 4)
    if not torch.equal(got.cpu(), want):
        fail(f"serve_batch f32: card tokens {got.tolist()} differ from the "
             f"CPU's {want.tolist()}")
    print(f"serve_batch f32 (8 x prompt 16, decode 4): the card's greedy "
          f"tokens are the CPU's ({want.shape[1]} per request)")
    # Where a decode step's time goes, bf16 as the CLI serves: 15 prompt
    # steps and 5 decoded.
    bcfg = registry.get_config("smollm-135m")
    bparams = M.init_params(bcfg, seed=0, device=dev)
    serve.serve_batch(bcfg, bparams, toks.to(dev), 4)
    profile_call("serve_batch bf16 (8 x prompt 16, decode 4)",
                 lambda: serve.serve_batch(bcfg, bparams, toks.to(dev), 4),
                 20, "decode step")
    return {"secs": secs, "launches": launches, "mean": mean,
            "exact": exact}


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
    """Where a steady epoch's time goes (see ``profile_call``)."""
    profile_call(f"{what} ({TICKS} ticks)", lambda: pipe.run_epoch(
        state, pipe.default_key, b.values, b.strata, b.counts), TICKS, "tick")


def profile_call(what, fn, units, unit):
    """Where one call's time goes: device time by kernel name from the
    profiler (see ``traced``), and the device's busy share of the wall
    time (the profiler's own cost inflates the wall time a little)."""
    torch.cuda.synchronize()
    windows, (wall,) = traced(fn, 1)
    # the run's window, the last that is not empty
    dev_events = next((w for w in reversed(windows) if w), [])
    wall_us = wall * 1e6
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
    print(f"profiled {what}: wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
          f"{len(dev_events)} device events ({len(dev_events) / units:.0f} "
          f"per {unit})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    for name, (count, us) in top:
        print(f"  {us / 1e3:8.3f} ms  {count:5d}x  {name[:90]}")


def sass_counts(lib: Path) -> None:
    """Count the bf16 flash kernel's tensor-core (HGMMA) and TMA
    (UTMALDG) instructions in the library's SASS, where the toolkit has
    ``cuobjdump``; fail if either is missing."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("cuobjdump not found: SASS instruction counts not taken")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    n = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    print(f"SASS of {lib.name}: {n['HGMMA']} HGMMA, {n['UTMALDG']} UTMALDG")
    if not all(n.values()):
        fail(f"flash_attention's SASS lacks wgmma or TMA loads: {n}")


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

    # f32 products in full f32, bf16 products summed in f32 (as XLA does
    # with preferred f32 accumulation), no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    sass_counts(_build.library_path("flash_attention"))

    # 2. Each kernel against its plain version.
    qspec = tenant_spec(P)
    qr = P.resolve(qspec)
    root_m = qr.capacities[-1]
    path_shapes = compact_shapes(qr.plan, root_m)
    err = check_kernels(dev)
    err.update(check_sketch_kernels(dev, path_shapes))
    err.update(check_slice3_kernels(dev))
    err["stratified_stats"] = max(err["stratified_stats"],
                                  check_stats_and_launches(dev))
    err["flash_attention"] = check_flash(dev)
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

    # The model zoo's serving half: SmolLM-135M's prefill through the
    # flash kernel, then the serve CLI.
    prefill = run_prefill(dev, LAUNCHES, reset_launches)
    served = run_serve(dev, LAUNCHES, reset_launches)

    # 4. Times, at the main path's shapes: device time from the profiler
    # (what ``ms``, ``plain_ms`` and ``library_ms`` report), and beside it
    # the wrapper loop's time on CUDA events, which includes the host.
    rng = np.random.default_rng(7)
    l0 = [t.to(dev) for t in level_inputs(rng, 4, 11008, 4, 0.73, True)]
    l1 = [t.to(dev) for t in level_inputs(rng, 2, 2200, 4, 1.0, True)]
    root = [t.to(dev) for t in level_inputs(rng, 1, 2200, 4, 1.0, True)]
    size = torch.tensor(1100.0, device=dev)
    root_tick = ft_ref.fused_level_tick(*root, size, 4, 1100)
    root_res = root_tick[5][0]
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

    # Operations any design of the level tick needs, whatever the data:
    # per slot a count, a compare with its stratum's tau and a placement
    # (not the passes of one design over the buffer).
    SLOT_OPS = 3

    ms_l0 = device_ms(lambda: tick(ft, l0), name="fused_level_tick")
    ms_l1 = device_ms(lambda: tick(ft, l1), name="fused_level_tick")
    t = {"fused_level_tick": (
             (ms_l0 + ms_l1) / 2,
             (device_ms(lambda: tick(ft_ref, l0), 5)
              + device_ms(lambda: tick(ft_ref, l1), 5)) / 2,
             None),
         "fused_select": (device_ms(lambda: ft.fused_select(*sel_args),
                                    name="fused_select"),
                          device_ms(lambda: ft_ref.fused_select(*sel_args),
                                    5),
                          None),
         "stratified_stats": (device_ms(lambda: ss.stratified_stats(*ss_args),
                                        name="stratified_stats"),
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
        # searchsorted + gather: the same function only where the intervals
        # partition [0, W), as these do; the sketch's do not always (its
        # blocked cumsum can fall by an ulp, and a target in the dip lies in
        # two slots), so the port never calls it.
        for v, _, cumw, tg in qc_cases:
            idx = torch.searchsorted(cumw, tg, right=True)
            torch.where(idx < v.shape[0],
                        v[idx.clamp_max(v.shape[0] - 1)], 0.0)

    n_cms, n_qc = len(cms_cases), len(qc_cases)
    t["cms_update"] = (device_ms(lambda: cms_all(sk), name="cms_update")
                       / n_cms,
                       device_ms(lambda: cms_all(sk_ref), 5) / n_cms,
                       device_ms(cms_library) / n_cms)
    ms_c, _, lib_c = t["cms_update"]
    print(f"cms_update at the tenants' (2200, 4, 1024) and (2200, 4, 256): "
          f"device {ms_c:.5f} ms/launch, index_add_ {lib_c:.5f} ms: kernel "
          f"/ library {ms_c / lib_c:.2f}x (earlier design: "
          f"{EARLIER_RATIO['cms_update']}x)")
    k, w = (a.to(dev) for a in cms_inputs(rng, 32000))
    flat = (torch.arange(4, device=dev)[:, None] * 8192
            + sk_ref.hash_buckets(k, 4, 8192)).reshape(-1)
    wf = w.expand(4, -1).reshape(-1)
    big = (device_ms(lambda: sk.cms_update(k, w, 4, 8192), 10),
           device_ms(lambda: torch.zeros(4 * 8192, device=dev).index_add_(
               0, flat, wf), 10))
    print(f"cms_update at (32000, 4, 8192): device {big[0]:.5f} ms, "
          f"index_add_ {big[1]:.5f} ms ({big[0] / big[1]:.2f}x)")
    t["quantile_compact"] = (device_ms(lambda: qc_all(sk),
                                       name="quantile_compact") / n_qc,
                             device_ms(lambda: qc_all(sk_ref), 5) / n_qc,
                             device_ms(qc_library) / n_qc)
    wall = {"fused_level_tick": (loop_ms(lambda: tick(ft, l0))
                                 + loop_ms(lambda: tick(ft, l1))) / 2,
            "fused_select": loop_ms(lambda: ft.fused_select(*sel_args)),
            "stratified_stats": loop_ms(lambda: ss.stratified_stats(*ss_args)),
            "cms_update": loop_ms(lambda: cms_all(sk)) / n_cms,
            "quantile_compact": loop_ms(lambda: qc_all(sk)) / n_qc}
    (n0, cap0), (n1, cap1), m = l0[0].shape, l1[0].shape, root[0].shape[1]
    b_l0 = bound(tick_bytes(n0, cap0, 1100, 4), SLOT_OPS * n0 * cap0)
    b_l1 = bound(tick_bytes(n1, cap1, 1100, 4), SLOT_OPS * n1 * cap1)
    n_masked = int(root[2][0].sum())
    bounds = {"fused_level_tick": ((b_l0[0] + b_l1[0]) / 2, b_l0[1]),
              # a count and a compare with tau per slot
              "fused_select": bound(m * 10 + 4 * 4, 2 * m),
              # count, Σx and Σx² (one multiply, two adds) per masked item
              "stratified_stats": bound(m * 9 + 4 * 12, 4 * n_masked)}
    # cms_update: keys and weights in (8 B per item), the table out; a
    # multiply, a shift and an add per item and depth row.
    cms_b = [bound(root_m * 8 + 4 * width * 4, 3 * 4 * root_m)
             for width in (1024, 256)]
    # quantile_compact: three f32 per slot and the targets in, one f32 per
    # target out; each slot and each target looked at once, as any design
    # must (not the TPU formulation's 2·P·C compares).
    qc_b = [bound(p * 12 + c * 8, p + c) for p, c in path_shapes]
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

    sm_each = [device_ms(lambda a=a: sm.sample_mask(*a), name="sample_mask")
               for a in sm_cases]
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
    # (2,200 items, 4 strata), a neyman level's stds (4 x 11,008) and a
    # tenant's histogram (32 bins, int64 ids). Bound: value and id per item
    # in, the sums out; one add per item. Its serial floor: the longest
    # segment's items times one dependent f32 add (tools/fadd_chain.py).
    # Plain = library = index_add_ (float atomics, unordered).
    import importlib.util

    probe = Path(__file__).resolve().parent / "tools" / "fadd_chain.py"
    spec_ = importlib.util.spec_from_file_location("fadd_chain", probe)
    fadd_chain = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(fadd_chain)
    chain = fadd_chain.measure(dev)
    print(f"dependent f32 add (tools/fadd_chain.py): "
          f"{chain['add_cycles']:.3f} cycles, {chain['add_ns']:.4f} ns; "
          f"folded from shared memory {chain['fold_cycles']:.3f} cycles, "
          f"{chain['fold_ns']:.4f} ns an item")
    seg_shapes = ((1, 2200, 4, torch.int32), (4, 11008, 4, torch.int32),
                  (1, 2200, 32, torch.int64))
    seg_cases = []
    for r, mm, x, dt in seg_shapes:
        v, i = ordered_inputs(rng, r, mm, x)
        seg_cases.append((v.to(dev), i.to(dt).to(dev), x))
    seg_ms = [device_ms(lambda a=a: segsum.segment_sum(*a),
                        name="segment_sum") for a in seg_cases]
    seg_plain = [device_ms(lambda a=a: segsum_ref.segment_sum(*a), 5)
                 for a in seg_cases]
    seg_wall = [loop_ms(lambda a=a: segsum.segment_sum(*a))
                for a in seg_cases]
    seg_b = [bound(r * mm * (4 + dt.itemsize) + r * x * 4, r * mm)
             for r, mm, x, dt in seg_shapes]
    for (r, mm, x, dt), (v, i, _), ms, pl, wl, b in zip(
            seg_shapes, seg_cases, seg_ms, seg_plain, seg_wall, seg_b):
        longest = int(max(((i == k).sum(-1).max() for k in range(x)),
                          default=0))
        name = f"segment_sum [{r}, {mm}] x {x}" + (
            " int64" if dt == torch.int64 else "")
        print(f"{name}: device {ms:.5f} ms/launch (wrapper loop {wl:.4f} "
              f"ms; earlier design {EARLIER_MS[name]}), bound "
              f"{b[0]:.6f} ms ({b[1]}), serial floor {longest} adds x "
              f"{chain['add_ns']:.4f} ns = "
              f"{longest * chain['add_ns'] * 1e-6:.5f} ms; plain = library "
              f"(index_add_, atomics) {pl:.5f} ms")
    print(f"segment_sum launches on the level-pallas driver run "
          f"{driver['level pallas'][1]['segment_sum']}; max abs err vs the "
          f"CPU {err['segment_sum']}")
    # stratified_stats at the pallas backend's three launches a tick and
    # off the path at 4,096 strata (the root's is t["stratified_stats"]):
    # zeros as values, as the backends pass.
    for mm, x in MASK_SHAPES + ((3000, 4096),):
        _, st, ok, _, _ = (a.to(dev) for a in mask_inputs(rng, mm, x, False))
        z = torch.zeros(mm, device=dev)
        ms = device_ms(lambda: ss.stratified_stats(z, st, ok, x),
                       name="stratified_stats")
        b = bound(mm * 9 + x * 12, 4 * int(ok.sum()))
        print(f"stratified_stats ({mm}, {x}): device {ms:.5f} "
              f"ms/launch (earlier design "
              f"{EARLIER_MS[f'stratified_stats ({mm}, {x})']}), bound "
              f"{b[0]:.6f} ms ({b[1]})")
    print(f"fused_level_tick device time per launch: L0 [{n0}, {cap0}] "
          f"{ms_l0:.4f} ms (bound {b_l0[0] * 1e3:.3f} us, {b_l0[1]}; "
          f"earlier design {EARLIER_MS['fused_level_tick L0']}), "
          f"L1 [{n1}, {cap1}] {ms_l1:.4f} ms (bound {b_l1[0] * 1e3:.3f} us, "
          f"{b_l1[1]}; earlier design {EARLIER_MS['fused_level_tick L1']})")
    ms_s = t["fused_select"][0]
    print(f"fused_select device time per launch at the root [{m}] x 4: "
          f"{ms_s:.4f} ms (bound {bounds['fused_select'][0] * 1e3:.4f} us; "
          f"earlier design {EARLIER_MS['fused_select']})")
    ms_q, _, lib_q = t["quantile_compact"]
    print(f"quantile_compact device time per launch over one root window's "
          f"{n_qc} launches: {ms_q:.5f} ms, searchsorted + gather "
          f"{lib_q:.5f} ms: kernel / library {ms_q / lib_q:.2f}x (earlier "
          f"design: {EARLIER_MS['quantile_compact']} ms, "
          f"{EARLIER_RATIO['quantile_compact']}x)")
    t["segment_sum"] = (seg_ms[0], seg_plain[0], seg_plain[0])
    bounds["segment_sum"] = seg_b[0]
    print(f"stratified_stats root ({m}, 4): device "
          f"{t['stratified_stats'][0]:.5f} ms/launch (earlier design "
          f"{EARLIER_MS['stratified_stats (2200, 4)']})")
    # flash_attention at SmolLM-135M's prefill (the main path's launch) and
    # Qwen3-4B's heads at S 4096, bf16; library: SDPA (causal, GQA), timed
    # here only.
    from torch.nn import functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    flash = {}
    for shape in (SMOLLM_ATTN, QWEN3_ATTN, SMOLLM_ATTN[:4] + (32,)):
        q, k, v = flash_inputs(shape, torch.bfloat16, 99, dev)
        flash[shape] = (
            device_ms(lambda: fa.flash_attention(q, k, v), 10,
                      name="flash_attention"),
            device_ms(lambda: fa_ref.flash_attention(q, k, v), 3),
            device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 10),
            flash_bound(shape))
        ms_f, plain_f, lib_f, b_f = flash[shape]
        was = (f" (earlier design: {EARLIER_RATIO[shape]}x)"
               if shape in EARLIER_RATIO else "")
        print(f"flash_attention {shape} bf16: device {ms_f:.4f} ms/launch, "
              f"bound {b_f[0]:.4f} ms ({b_f[1]}), {b_f[0] / ms_f:.2%} of "
              f"the bound, {flash_ops(shape) / ms_f / 1e9:.1f} TFLOP/s; "
              f"plain {plain_f:.4f} ms; SDPA {lib_f:.4f} ms; kernel / SDPA "
              f"{ms_f / lib_f:.2f}x{was}")
        del q, k, v
    q, k, v = flash_inputs(F32_ATTN, torch.float32, 98, dev)
    f32 = (device_ms(lambda: fa.flash_attention(q, k, v), 10),
           device_ms(lambda: fa_ref.flash_attention(q, k, v), 3),
           device_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True), 10))
    print(f"flash_attention {F32_ATTN} f32 (CUDA cores): device "
          f"{f32[0]:.4f} ms/launch; plain {f32[1]:.4f} ms; SDPA {f32[2]:.4f} "
          f"ms; kernel / SDPA {f32[0] / f32[2]:.2f}x")
    del q, k, v
    t["flash_attention"] = flash[SMOLLM_ATTN][:3]
    bounds["flash_attention"] = flash[SMOLLM_ATTN][3]
    tiny = torch.zeros(1, device=dev)
    print(f"launch floor (1-element add_): device "
          f"{device_ms(lambda: tiny.add_(1.0), 200):.4f} ms, back-to-back "
          f"loop {loop_ms(lambda: tiny.add_(1.0), 200):.4f} ms")
    # Each kernel's own time is the median of up to TRACES traces; per
    # timing: min, median and max ms, traces kept and rejected, or the
    # CUDA-event time where every trace was rejected (cms_update and
    # quantile_compact per window, not per launch).
    for name, runs in SPREAD.items():
        print(f"{name} device ms over traces (min, median, max): " + "; ".join(
            f"{min(r):.5f}, {statistics.median(r):.5f}, {max(r):.5f} "
            f"({len(r)} kept, {rej} rejected)" if r else
            f"CUDA events {ms:.5f} ({rej} rejected)" for r, rej, ms in runs))
    per_tick = dict(per_window, sample_mask=3)
    for name, (ms, plain_ms, lib_ms) in t.items():
        if name in ("segment_sum", "flash_attention"):
            continue
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
    # launches: the tenant path's for the five kernels on it and
    # segment_sum, the pallas driver run's for sample_mask, one SmolLM-135M
    # prefill's for flash_attention.
    path_launches = dict(
        q_launches, sample_mask=driver["level pallas"][1]["sample_mask"],
        flash_attention=prefill["launches"]["flash_attention"])
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
