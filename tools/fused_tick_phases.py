"""Where the time of the fused level tick and the fused selection goes, on
a CUDA card, and how it depends on the number of CTAs per node.

Builds ``csrc/fused_level_tick.cu`` twice: as the port builds it, and with
``-DREPRO_PHASE_PROBE``, where thread 0 of every CTA writes the global
timer at the end of each phase. For the main path's three launches
(testbed level 0 ``[4, 11008]``, level 1 ``[2, 2200]``, the root's
selection over 2,200 items; 4 strata, fair allocation, budget 1,100) and
each cluster size 1, 2, 4 and 8, and for the skewed cell's two neyman
launches (``approxiot-skew``: level 0 ``[4, 2700032]`` with about 2.0M
valid items a node, budget 270,003; level 1 ``[2, 540006]`` holding level
0's kept rows, budget 54,000) at the wrapper's cluster size, it

- checks the kernel against the plain version, bitwise;
- prints the device time of one launch (``chip_smoke.device_ms``, the
  median of profiler traces) of the port's build;
- prints, from the probe build, each phase's end in microseconds after
  the earliest CTA start of the launch, taking the latest CTA (median
  over 20 launches); the allocation's end is rank 0's;
- for neyman, prints the moments' phase (from the gather's end to the
  moments' end) beside its chain floor: the largest stratum's valid
  items in a node times one dependent f32 add (``tools/fadd_chain.py``,
  measured in the same process).

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

sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as C  # noqa: E402
import fadd_chain  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fused_level_tick import ops, ref  # noqa: E402

CLUSTERS = (1, 2, 4, 8)
PHASES = {0: "start", 1: "counts", 2: "barrier 1", 3: "gather",
          25: "moments", 4: "allocation", 5: "weights", 6: "barrier 2"}
GATHER, MOMENTS = 3, 25
# approxiot-skew's stream (bench/configs/approxiot-skew.json): shares and
# Poisson means of its four sub-streams.
SKEW_SHARES = (0.8, 0.1989, 0.001, 0.0001)
SKEW_LAMBDAS = (10.0, 100.0, 1e3, 1e7)


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


def skew_level(rng, n, cap, live):
    """A stacked level of the skewed stream: ``live[i]`` valid items at
    the front of node i, strata by the shares, Poisson values."""
    strata = rng.choice(4, size=(n, cap), p=np.array(SKEW_SHARES) /
                        sum(SKEW_SHARES)).astype(np.int32)
    vals = rng.poisson(np.array(SKEW_LAMBDAS)[strata]).astype(np.float32)
    valid = np.arange(cap)[None, :] < np.asarray(live)[:, None]
    u = rng.random((n, cap)).astype(np.float32)
    w_in = np.ones((n, 4), np.float32)
    c_in = np.zeros((n, 4), np.float32)
    return [torch.from_numpy(a) for a in (vals, strata, valid, u, w_in, c_in)]


def skew_levels(rng):
    """The skewed cell's level 0 and, from its plain tick, level 1 (each
    node holds two children's kept rows), on the CPU: ``(level, budget,
    plain tick or None)`` each."""
    l0 = skew_level(rng, 4, 2700032, rng.integers(1_990_000, 2_010_001, 4))
    size0 = torch.tensor(270003.0)
    out = ref.fused_level_tick(*l0, size0, 4, 270003, allocation="neyman")
    vals_c, strata_c, n_keep = out[1], out[2], out[3]
    rows = vals_c.shape[1]
    valid = (torch.arange(rows)[None, :] < n_keep[:, None]).reshape(2, -1)
    l1 = [vals_c.reshape(2, -1).contiguous(),
          strata_c.reshape(2, -1).contiguous(), valid.contiguous(),
          torch.from_numpy(rng.random((2, 2 * rows)).astype(np.float32)),
          torch.ones((2, 4)), torch.zeros((2, 4))]
    return (l0, size0, out), (l1, torch.tensor(54000.0), None)


def chain_items(lvl, x):
    """The most valid items of one stratum in one node."""
    strata, valid = lvl[1], lvl[2]
    return max(int(torch.bincount(strata[i][valid[i]].long(),
                                  minlength=x).max())
               for i in range(strata.shape[0]))


def tick_call(lib, cs, lvl, size, x, oc, policy=0):
    """A launch of ``lib``'s level tick at cluster size ``cs``, as the
    wrapper makes it (``policy``: the wrapper's number for the
    allocation)."""
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
            P(size), n, cap, x, oc, policy, 1, cs, P(scratch), P(ties),
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
    med = {s: statistics.median(r[s] for r in runs) for s in runs[0]}
    return [(phase_name(s, slots), med[s])
            for s in sorted(med, key=lambda s: (med[s], s))]


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

    add_ns = fadd_chain.measure(dev)["add_ns"]
    neyman = ops._POLICIES["neyman"]
    skew = skew_levels(np.random.default_rng(11))
    for (lvl, budget, want), name in zip(skew, ("skew level 0 [4, 2700032]",
                                                "skew level 1 [2, 540006]")):
        oc = int(budget)
        if want is None:
            want = ref.fused_level_tick(*lvl, budget, 4, oc,
                                        allocation="neyman")
        args = [t.to(dev) for t in lvl]
        size_d = budget.to(dev)

        def make(l, args=args, size_d=size_d, oc=oc):
            return tick_call(l, ops.CLUSTER, args, size_d, 4, oc, neyman)
        call, ctas = make(lib)
        got = call()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not C.same_bits(g.cpu(), w):
                sys.exit(f"fused_tick_phases: {name} (neyman) differs from "
                         f"the plain version")
        ms = C.device_ms(call, 20)
        steps = phases(probe, make, ctas)
        at = dict(steps)
        items = chain_items(lvl, 4)
        print(f"{name}, neyman, {ops.CLUSTER} CTAs a node: device {ms:.4f} "
              f"ms, bitwise the plain version; moments phase "
              f"{at['moments'] - at['gather']:.1f} us against its chain "
              f"floor {items * add_ns / 1e3:.1f} us ({items} items of one "
              f"stratum x {add_ns:.4f} ns an add); phase ends (us, median "
              f"of 20): " + ", ".join(f"{p} {t:.2f}" for p, t in steps))


if __name__ == "__main__":
    main()
