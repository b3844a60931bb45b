"""Where the time of ``segment_sum`` and ``stratified_stats`` goes, on a
CUDA card.

Builds ``csrc/segment_sum.cu`` and ``csrc/stratified_stats.cu`` with
``-DREPRO_PHASE_PROBE``, where thread 0 of every CTA writes the global
timer at the end of each phase. At each kernel's path shapes
(``chip_smoke.py``'s phase-4 inputs, seed 7) it

- checks the probe build against the plain version (``segment_sum``
  bitwise; ``stratified_stats``' counts bitwise, sums within 1e-5);
- prints the device time of one launch of the port's own build
  (``chip_smoke.device_ms``, the median of profiler traces);
- prints, from the probe build, each phase's end in microseconds after
  the earliest CTA start of the launch, taking the latest CTA, and CTA
  0's SM clock over the launch (clock64 cycles over global-timer ns;
  medians over 20 launches).

``segment_sum``'s phases repeat per chunk of 4,096 items: rank (each
warp's ranks and counts), scan (the runs' offsets), scatter (the sorted
chunk), fold (the segments' adds). ``stratified_stats``: zero (the rows),
items, combine (the CTA's partials, stored into CTA 0), cluster (the
barrier), out (CTA 0's adds over the CTAs, or the warps' rows added above
24 strata, and the output written).

    python3 tools/sum_phases.py
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.segment_sum import ops as seg  # noqa: E402
from repro_torch.kernels.segment_sum import ref as seg_ref  # noqa: E402
from repro_torch.kernels.stratified_stats import ops as ss  # noqa: E402
from repro_torch.kernels.stratified_stats import ref as ss_ref  # noqa: E402

SEG_PHASES = ("rank", "scan", "scatter", "fold")
SS_PHASES = ("start", "zero", "items", "combine", "cluster", "out")


def build_probe(name: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe" / f"lib{name}_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-DREPRO_PHASE_PROBE", "-I",
           str(_build.CSRC), "-o", str(out), str(_build.CSRC / f"{name}.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    getattr(lib, f"{name}_set_probe").argtypes = [P]
    getattr(lib, f"{name}_probe_slots").restype = I
    if name == "segment_sum":
        for fn in (lib.segment_sum_launch, lib.segment_sum_launch_i64):
            fn.argtypes = [P, P, I, I, I, P, P]
            fn.restype = I
    else:
        lib.stratified_stats_launch.argtypes = [P, P, P, I, I, P, P]
        lib.stratified_stats_launch.restype = I
    lib.repro_cuda_error_string.argtypes = [I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def phases(lib, name, call, ctas, reps=20):
    """({slot: us after the earliest CTA start, latest CTA}, GHz): the
    median over ``reps`` launches, and CTA 0's SM clock from its first to
    its last stamp."""
    slots = getattr(lib, f"{name}_probe_slots")()
    buf = torch.full((ctas * slots * 2,), -1, dtype=torch.int64,
                     device="cuda")
    getattr(lib, f"{name}_set_probe")(_build.ptr(buf))
    runs, ghz = [], []
    for _ in range(reps):
        buf.fill_(-1)
        call()
        torch.cuda.synchronize()
        t = buf.view(ctas, slots, 2).cpu().numpy()
        ns = t[:, :, 0]
        t0 = ns[:, 0].min()
        runs.append({s: (ns[:, s].max() - t0) / 1e3 for s in range(slots)
                     if (ns[:, s] >= 0).any()})
        done = [s for s in range(slots) if t[0, s, 0] >= 0]
        ghz.append((t[0, done[-1], 1] - t[0, 0, 1])
                   / max(t[0, done[-1], 0] - t[0, 0, 0], 1))
    getattr(lib, f"{name}_set_probe")(None)
    return ({s: statistics.median(r[s] for r in runs)
             for s in sorted(runs[0])}, statistics.median(ghz))


def seg_call(lib, v, i, x):
    rows, m = v.shape
    out = torch.empty((rows, x), device=v.device)
    fn = (lib.segment_sum_launch_i64 if i.dtype == torch.int64
          else lib.segment_sum_launch)

    def call():
        _build.check(lib, fn(_build.ptr(v), _build.ptr(i), rows, m, x,
                             _build.ptr(out), _build.stream_of(v)),
                     "segment_sum")
        return out
    return call


def ss_call(lib, z, s, k, x):
    out = torch.empty((x, 3), device=z.device)

    def call():
        _build.check(lib, lib.stratified_stats_launch(
            _build.ptr(z), _build.ptr(s), _build.ptr(k), z.shape[0], x,
            _build.ptr(out), _build.stream_of(z)), "stratified_stats")
        return out
    return call


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("sum_phases: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    probes = {n: build_probe(n) for n in ("segment_sum", "stratified_stats")}
    rng = np.random.default_rng(7)
    for rows, m, x, dt in ((1, 2200, 4, torch.int32),
                           (4, 11008, 4, torch.int32),
                           (1, 2200, 32, torch.int64)):
        v, i = C.ordered_inputs(rng, rows, m, x)
        i = i.to(dt)
        want = seg_ref.segment_sum(v, i, x)
        v, i = v.to(dev), i.to(dev)
        call = seg_call(probes["segment_sum"], v, i, x)
        if not C.same_bits(call(), want):
            sys.exit(f"sum_phases: segment_sum [{rows}, {m}] x {x} differs "
                     f"from the CPU")
        ms = C.device_ms(lambda: seg.segment_sum(v, i, x))
        t, ghz = phases(probes["segment_sum"], "segment_sum", call, rows)
        steps = [(f"{SEG_PHASES[(s - 1) % 4]} {(s - 1) // 4}"
                  if 0 < s < 31 else ("start" if s == 0 else "exit"), us)
                 for s, us in t.items()]
        print(f"segment_sum [{rows}, {m}] x {x} {str(dt)[6:]}: device "
              f"{ms:.5f} ms; probe build at {ghz:.3f} GHz, phase ends (us): "
              + ", ".join(f"{p} {us:.2f}" for p, us in steps))
    cases = [(2200, 4)] + list(C.MASK_SHAPES[:2]) + [(3000, 4096)]
    for m, x in cases:
        _, s, k, _, _ = C.mask_inputs(rng, m, x, False)
        vals = torch.from_numpy(rng.normal(100, 25, m).astype(np.float32))
        want = ss_ref.stratified_stats(vals, s, k, x)
        vals, s, k = vals.to(dev), s.to(dev), k.to(dev)
        call = ss_call(probes["stratified_stats"], vals, s, k, x)
        got = call().cpu()
        if not (C.same_bits(got[:, 0], want[:, 0]) and torch.allclose(
                got[:, 1:], want[:, 1:], rtol=C.SUMS_RTOL, atol=0.0)):
            sys.exit(f"sum_phases: stratified_stats ({m}, {x}) differs from "
                     f"the plain version")
        ms = C.device_ms(lambda: ss.stratified_stats(vals, s, k, x))
        ctas = min(max(-(-m // 4096), 1), 8) if x <= 24 else 1
        t, ghz = phases(probes["stratified_stats"], "stratified_stats",
                        call, ctas)
        print(f"stratified_stats ({m}, {x}), {ctas} CTA(s): device "
              f"{ms:.5f} ms; probe build at {ghz:.3f} GHz, phase ends (us): "
              + ", ".join(f"{SS_PHASES[s]} {us:.2f}" for s, us in t.items()))


if __name__ == "__main__":
    main()
