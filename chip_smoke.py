"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives ``src/repro_torch`` only (nothing of JAX or of the JAX package):

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc`` for sm_90a;
2. holds each kernel against its plain PyTorch version on the same
   inputs — at the paper testbed's shapes and at the kernel's limit
   (cap 8192, 32 strata), saturated or not, front-packed or not, with
   ``out_capacity`` below the keep count, with exact f32 priority ties,
   for the fair, proportional and neyman allocations. Masks, counts,
   reservoirs, weights, compacted buffers and ``n_keep`` must agree
   bitwise; ``stratified_stats``' Σx and Σx² within ``SUMS_RTOL``;
3. runs the paper testbed (fanin 4→2→1, capacity 11008, 4 strata,
   fraction 0.1, ``pallas_fused``) through ``compile``/``init``/
   ``run_epoch`` on the card for ``EPOCHS`` epochs of ``TICKS`` ticks,
   checks that every kernel launched as often as the path requires,
   holds the answers against the same run on the CPU, checks the SUM
   against the exact sum and its bound, and runs ``mode="srs"`` once;
4. times each kernel at the main path's shapes beside its bound, its
   plain version and (where one exists) one PyTorch call computing the
   same function, as device time from the profiler's CUDA trace, and
   times the WHS and SRS epochs;
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

EPOCHS = 4
TICKS = 16
SUMS_RTOL = 1e-5        # Σx, Σx²: fixed-order f32 sums vs item-order sums
ANSWER_RTOL = {         # card vs CPU run of the whole pipeline
    "sum": 1e-5, "mean": 1e-5, "histogram": 1e-5,
    # s² = (Σx² − Y·mean²)/(Y−1) cancels ~3 digits at the testbed's values
    "sum_var": 1e-3, "mean_var": 1e-3,
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# H100 SXM data sheet: f32 outside the tensor cores (the sheet gives no
# rate for the int32 compares the kernels mostly do).
ALU_OPS_PER_S = 67e12
REPLACES = {
    "fused_level_tick":
        "src/repro/kernels/fused_level_tick/fused_level_tick.py:229",
    "fused_select":
        "src/repro/kernels/fused_level_tick/fused_level_tick.py:310",
    "stratified_stats":
        "src/repro/kernels/stratified_stats/stratified_stats.py:53",
}
SOURCES = {
    "fused_level_tick": "src/repro_torch/csrc/fused_level_tick.cu",
    "fused_select": "src/repro_torch/csrc/fused_level_tick.cu",
    "stratified_stats": "src/repro_torch/csrc/stratified_stats.cu",
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


# ------------------------------------------------------------ main path --
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


def compare_answers(card, cpu, what):
    exact = ("tick", "ok", "n_sampled", "n_forwarded")
    for wa_k, wa_p in zip(card, cpu):
        for f in exact:
            if not same_bits(getattr(wa_k, f), getattr(wa_p, f)):
                fail(f"{what}: {f} differs between the card and the CPU")
        for f, rtol in ANSWER_RTOL.items():
            k, p = getattr(wa_k, f).cpu(), getattr(wa_p, f)
            if not torch.isfinite(k).all():
                fail(f"{what}: {f} is not finite on the card")
            if not torch.allclose(k, p, rtol=rtol, atol=0.0):
                worst = float(((k - p).abs() / p.abs().clamp_min(1e-30))
                              .max())
                fail(f"{what}: {f} differs from the CPU run by {worst:.3g} "
                     f"relative (> {rtol})")


def compare_states(card, cpu, what):
    from repro_torch.core.window import TreeState

    for f in TreeState.LEVEL_FIELDS:
        for l, (k, p) in enumerate(zip(getattr(card.tree, f),
                                       getattr(cpu.tree, f))):
            if not same_bits(k, p):
                fail(f"{what}: state {f}[{l}] differs between the card "
                     f"and the CPU")


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
    err = check_kernels(dev)
    print(f"max abs differences vs plain: {err}")

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
    expected = {"fused_level_tick": 2 * ticks, "fused_select": ticks,
                "stratified_stats": ticks}
    print(f"launches on the main path: {launches} (expected {expected})")
    for name, want in expected.items():
        if launches[name] != want:
            fail(f"{name} launched {launches[name]} times on the main "
                 f"path, expected {want}")
    _, cpu_state, cpu_answers, cpu_secs, _ = run_path(P, spec, "cpu",
                                                      batches)
    compare_answers(answers, cpu_answers, "whs")
    compare_states(state, cpu_state, "whs")
    print("main path: answers and state agree with the CPU run "
          f"(ok/n_sampled/n_forwarded/state bitwise, sums within "
          f"{ANSWER_RTOL})")
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

    srs_spec = testbed_spec(P, mode="srs")
    srs_batches = make_ingest(S, 2, srs_spec.topology.capacity)
    srs_pipe, srs_state, srs_ans, srs_secs, srs_items = run_path(
        P, srs_spec, dev, srs_batches)
    _, srs_cpu_state, srs_cpu_ans, _, _ = run_path(P, srs_spec, "cpu",
                                                   srs_batches)
    compare_answers(srs_ans, srs_cpu_ans, "srs")
    compare_states(srs_state, srs_cpu_state, "srs")
    srs_approx = sum(row["sum"] for wa in srs_ans for row in srs_pipe.rows(wa))
    srs_exact = sum(b.exact_sum for b in srs_batches)
    print(f"srs: SUM ~ {srs_approx:.6e}, exact {srs_exact:.6e}, |err| "
          f"{abs(srs_approx - srs_exact) / srs_exact:.3e} relative; "
          f"agrees with the CPU run")

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
    wall = {"fused_level_tick": (loop_ms(lambda: tick(ft, l0))
                                 + loop_ms(lambda: tick(ft, l1))) / 2,
            "fused_select": loop_ms(lambda: ft.fused_select(*sel_args)),
            "stratified_stats": loop_ms(lambda: ss.stratified_stats(*ss_args))}
    (n0, cap0), (n1, cap1), m = l0[0].shape, l1[0].shape, root[0].shape[1]
    b_l0 = bound(tick_bytes(n0, cap0, 1100, 4), tick_ops(l0))
    b_l1 = bound(tick_bytes(n1, cap1, 1100, 4), tick_ops(l1))
    n_masked = int(root[2][0].sum())
    bounds = {"fused_level_tick": ((b_l0[0] + b_l1[0]) / 2, b_l0[1]),
              "fused_select": bound(m * 10 + 4 * 4,
                                    m * select_passes(root_c, root_res, 4)),
              # count, Σx and Σx² (one multiply, two adds) per masked item
              "stratified_stats": bound(m * 9 + 4 * 12, 4 * n_masked)}
    print(f"fused_level_tick device time per launch: L0 [{n0}, {cap0}] "
          f"{ms_l0:.4f} ms (bound {b_l0[0] * 1e3:.3f} us, {b_l0[1]}), "
          f"L1 [{n1}, {cap1}] {ms_l1:.4f} ms (bound {b_l1[0] * 1e3:.3f} us, "
          f"{b_l1[1]})")
    tiny = torch.zeros(1, device=dev)
    print(f"launch floor (1-element add_): device "
          f"{device_ms(lambda: tiny.add_(1.0), 200):.4f} ms, back-to-back "
          f"loop {loop_ms(lambda: tiny.add_(1.0), 200):.4f} ms")
    per_tick = {"fused_level_tick": 2, "fused_select": 1,
                "stratified_stats": 1}
    for name, (ms, plain_ms, lib_ms) in t.items():
        print(f"{name}: device {ms:.4f} ms/launch (wrapper loop "
              f"{wall[name]:.4f} ms), {per_tick[name]} launch(es) per tick, "
              f"bound {bounds[name][0]:.6f} ms ({bounds[name][1]}), plain "
              f"device {plain_ms:.4f} ms"
              + (f", index_add_ device {lib_ms:.4f} ms" if lib_ms else ""))
    steady = secs[1:] or secs
    ms_epoch = 1e3 * sum(steady) / len(steady)
    rate = sum(items[1:] or items) / sum(steady)
    print(f"whs epoch ({TICKS} ticks): {', '.join(f'{s * 1e3:.1f}' for s in secs)}"
          f" ms (first includes warm-up); steady {ms_epoch:.1f} ms, "
          f"{rate:.4g} items/s on the card; CPU run "
          f"{1e3 * sum(cpu_secs) / len(cpu_secs):.1f} ms/epoch")
    srs_rate = srs_items[-1] / srs_secs[-1]
    print(f"srs epoch ({TICKS} ticks): "
          f"{', '.join(f'{s * 1e3:.1f}' for s in srs_secs)} ms (first "
          f"includes warm-up); steady {srs_rate:.4g} items/s on the card")

    # Where a steady WHS epoch's time goes: device time by kernel name
    # from the profiler, and the device's busy share of the wall time
    # (the profiler's own cost inflates the wall time a little).
    b = batches[-1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = pipe.run_epoch(state, pipe.default_key, b.values,
                                  b.strata, b.counts)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if dev_events:
        by_name: dict[str, list] = {}
        for e in dev_events:
            rec = by_name.setdefault(e.name, [0, 0.0])
            rec[0] += 1
            rec[1] += e.time_range.elapsed_us()
        busy = sum(r[1] for r in by_name.values())
        print(f"profiled whs epoch ({TICKS} ticks): wall {wall_us / 1e3:.1f} "
              f"ms, device busy {busy / 1e3:.2f} ms "
              f"({100 * busy / wall_us:.1f}%), {len(dev_events)} device "
              f"events ({len(dev_events) / TICKS:.0f} per tick)")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        for name, (count, us) in top:
            print(f"  {us / 1e3:8.3f} ms  {count:5d}x  {name[:90]}")
    else:
        print("profiled whs epoch: the profiler saw no device events; "
              "device busy share not measured")

    # 5. Result lines.
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
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
