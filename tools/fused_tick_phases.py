"""Where the time of the fused level tick and the fused selection goes, on
a CUDA card, and how it depends on the number of CTAs per node.

Builds ``csrc/fused_level_tick.cu`` twice: as the port builds it, and with
``-DREPRO_PHASE_PROBE``, where thread 0 of every CTA writes the global
timer at the end of each phase. For the main path's three launches
(testbed level 0 ``[4, 11008]``, level 1 ``[2, 2200]``, the root's
selection over 2,200 items; 4 strata, fair allocation, budget 1,100) and
each cluster size 1, 2, 4 and 8 it

- checks the kernel against the plain version, bitwise;
- prints the device time of one launch (``chip_smoke.device_ms``, the
  median of profiler traces) of the port's build;
- prints, from the probe build, each phase's end in microseconds after
  the earliest CTA start of the launch, taking the latest CTA (median
  over 20 launches); the allocation's end is rank 0's.

    python3 tools/fused_tick_phases.py
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
from repro_torch.kernels.fused_level_tick import ops, ref  # noqa: E402

CLUSTERS = (1, 2, 4, 8)
PHASES = {0: "start", 1: "counts", 2: "barrier 1", 3: "gather",
          4: "allocation", 5: "weights", 6: "barrier 2"}


def phase_name(slot: int, slots: int) -> str:
    if slot in PHASES:
        return PHASES[slot]
    if 7 <= slot < slots - 6:
        p, k = divmod(slot - 7, 3)
        return (f"push {p}", f"choose {p}", f"histogram {p + 1}")[k]
    return {slots - 6: "strict/ties", slots - 5: "barrier",
            slots - 4: "exchange", slots - 3: "keeps", slots - 2: "compact",
            slots - 1: "exit barrier"}[slot]


def build_probe() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe" / "libfused_level_tick_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-DREPRO_PHASE_PROBE", "-I",
           str(_build.CSRC), "-o", str(out),
           str(_build.CSRC / "fused_level_tick.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fused_level_tick_launch.argtypes = [P] * 7 + [I] * 7 + [P] * 11 + [P]
    lib.fused_select_launch.argtypes = [P, P, P, P, I, I, I, P, P, P]
    for fn in (lib.fused_level_tick_launch, lib.fused_select_launch):
        fn.restype = I
    lib.fused_level_tick_scratch_words.argtypes = [I]
    lib.fused_level_tick_scratch_words.restype = I
    lib.repro_cuda_error_string.argtypes = [I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tick_call(lib, cs, lvl, size, x, oc):
    """A launch of ``lib``'s level tick at cluster size ``cs``, as the
    wrapper makes it."""
    values, strata, valid, prio, w_in, c_in = lvl
    n, cap = values.shape
    dev = values.device
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty((n, cap), dtype=torch.bool, device=dev),
            torch.empty((n, oc), **f32),
            torch.empty((n, oc), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev)]
    outs += [torch.empty((n, x), **f32) for _ in range(5)]
    scratch = torch.empty((n * lib.fused_level_tick_scratch_words(x),), **f32)
    ties = torch.empty((n * cap,), dtype=torch.int32, device=dev)
    P = _build.ptr

    def call():
        rc = lib.fused_level_tick_launch(
            P(values), P(strata), P(valid), P(prio), P(w_in), P(c_in),
            P(size), n, cap, x, oc, 0, 1, cs, P(scratch), P(ties),
            *(P(o) for o in outs), _build.stream_of(values))
        _build.check(lib, rc, "fused_level_tick")
        return outs
    return call, n * cs


def select_call(lib, cs, args):
    prio, strata, valid, res, x = args
    m = prio.shape[0]
    keep = torch.empty((m,), dtype=torch.bool, device=prio.device)
    ties = torch.empty((m,), dtype=torch.int32, device=prio.device)
    P = _build.ptr

    def call():
        rc = lib.fused_select_launch(P(prio), P(strata), P(valid), P(res), m,
                                     x, cs, P(ties), P(keep),
                                     _build.stream_of(prio))
        _build.check(lib, rc, "fused_select")
        return [keep]
    return call, cs


def phases(probe_lib, make, ctas, reps=20):
    slots = probe_lib.fused_level_tick_probe_slots()
    buf = torch.full((ctas * slots,), -1, dtype=torch.int64, device="cuda")
    probe_lib.fused_level_tick_set_probe(_build.ptr(buf))
    call, _ = make(probe_lib)
    runs = []
    for _ in range(reps):
        buf.fill_(-1)
        call()
        torch.cuda.synchronize()
        t = buf.view(ctas, slots).cpu().numpy()
        t0 = t[:, 0].min()
        runs.append({s: (t[:, s].max() - t0) / 1e3 for s in range(slots)
                     if (t[:, s] >= 0).any()})
    probe_lib.fused_level_tick_set_probe(None)
    keys = sorted(runs[0])
    return [(phase_name(s, slots), statistics.median(r[s] for r in runs))
            for s in keys]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("fused_tick_phases: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    lib = bind(ops._lib())
    probe = bind(build_probe())
    probe.fused_level_tick_set_probe.argtypes = [ctypes.c_void_p]
    probe.fused_level_tick_set_probe.restype = ctypes.c_int
    probe.fused_level_tick_probe_slots.restype = ctypes.c_int
    rng = np.random.default_rng(7)
    l0 = [t.to(dev) for t in C.level_inputs(rng, 4, 11008, 4, 0.73, True)]
    l1 = [t.to(dev) for t in C.level_inputs(rng, 2, 2200, 4, 1.0, True)]
    root = [t.to(dev) for t in C.level_inputs(rng, 1, 2200, 4, 1.0, True)]
    size = torch.tensor(1100.0, device=dev)
    root_res = ref.fused_level_tick(*root, size, 4, 1100)[5][0]
    sel = (root[3][0], root[1][0], root[2][0], root_res, 4)
    cases = {"level 0 [4, 11008]": ("tick", l0), "level 1 [2, 2200]":
             ("tick", l1), "root select [2200]": ("select", sel)}
    for name, (kind, args) in cases.items():
        if kind == "tick":
            want = ref.fused_level_tick(*args, size, 4, 1100)
        else:
            want = [ref.fused_select(*args)]
        for cs in CLUSTERS:
            def make(l, cs=cs, kind=kind, args=args):
                if kind == "tick":
                    return tick_call(l, cs, args, size, 4, 1100)
                return select_call(l, cs, args)
            call, ctas = make(lib)
            got = call()
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not C.same_bits(g, w):
                    sys.exit(f"fused_tick_phases: {name} at {cs} CTAs a "
                             f"node differs from the plain version")
            ms = C.device_ms(call, 20)
            steps = phases(probe, make, ctas)
            print(f"{name}, {cs} CTA(s) a node: device {ms:.4f} ms, bitwise "
                  f"the plain version; probe build, phase ends (us after "
                  f"the first CTA start, median of 20): " + ", ".join(
                      f"{p} {t:.2f}" for p, t in steps))


if __name__ == "__main__":
    main()
