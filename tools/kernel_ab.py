"""Device times of ``fused_level_tick``, ``fused_select``,
``quantile_compact``, ``segment_sum`` and ``stratified_stats`` for two
source trees of the port, in one call on one CUDA card.

    python3 tools/kernel_ab.py OTHER_TREE

``OTHER_TREE`` is another checkout of the repository (for example the
parent commit unpacked with ``git archive``). Each tree runs in a process
of its own, in the order other, this, this, other, and builds its kernels
into its own ``build/``. The inputs are ``chip_smoke.py``'s phase-4 inputs
(this tree's generators, seed 7): the testbed's level 0 ``[4, 11008]`` and
level 1 ``[2, 2200]`` ticks and the root's selection over 2,200 items (4
strata, budget 1,100), ``quantile_compact`` at one root window's 20
launch shapes of the tenant path, ``segment_sum`` on order-sensitive sums
at ``[1, 2200] x 4`` (a root window's moments), ``[4, 11008] x 4`` (a
neyman level's stds) and ``[1, 2200] x 32`` with int64 ids (a tenant's
histogram), and ``stratified_stats`` at the root's ``(2200, 4)`` on
``pallas_fused``, at ``chip_smoke.MASK_SHAPES`` (the ``pallas``
backend's three launches a tick) and at ``(3000, 4096)``. Times are
``chip_smoke.device_ms`` (the median of profiler traces), per launch.
Prints one JSON line per run and the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(tree: Path, path_shapes) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.kernels.fused_level_tick import ops as ft, ref as ft_ref
    from repro_torch.kernels.segment_sum import ops as seg
    from repro_torch.kernels.sketch_update import ops as sk
    from repro_torch.kernels.stratified_stats import ops as ss

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    l0 = [t.to(dev) for t in C.level_inputs(rng, 4, 11008, 4, 0.73, True)]
    l1 = [t.to(dev) for t in C.level_inputs(rng, 2, 2200, 4, 1.0, True)]
    root = [t.to(dev) for t in C.level_inputs(rng, 1, 2200, 4, 1.0, True)]
    size = torch.tensor(1100.0, device=dev)
    res = ft_ref.fused_level_tick(*root, size, 4, 1100)[5][0]
    sel = (root[3][0], root[1][0], root[2][0], res, 4)
    qc = [[a.to(dev) for a in C.intervals(rng, p, c)] for p, c in path_shapes]

    def qc_all():
        for args in qc:
            sk.quantile_compact(*args)

    sums = {}
    for rows, m, x, ids in ((1, 2200, 4, torch.int32),
                            (4, 11008, 4, torch.int32),
                            (1, 2200, 32, torch.int64)):
        v, s = (a.to(dev) for a in C.ordered_inputs(rng, rows, m, x))
        s = s.to(ids)
        name = f"segment_sum [{rows}, {m}] x {x}" + (
            " int64" if ids == torch.int64 else "")
        sums[name] = C.device_ms(
            lambda v=v, s=s, x=x: seg.segment_sum(v, s, x))
    zeros = torch.zeros(2200, device=dev)
    stats = {"stratified_stats root (2200, 4)": C.device_ms(
        lambda: ss.stratified_stats(zeros, root[1][0], root[2][0], 4))}
    for m, x in C.MASK_SHAPES + ((3000, 4096),):
        _, strata, valid, _, _ = (a.to(dev) for a in C.mask_inputs(
            rng, m, x, False))
        z = torch.zeros(m, device=dev)
        stats[f"stratified_stats ({m}, {x})"] = C.device_ms(
            lambda z=z, s=strata, k=valid, x=x: ss.stratified_stats(z, s, k,
                                                                    x))
    return {
        "tree": str(tree),
        "fused_level_tick L0": C.device_ms(
            lambda: ft.fused_level_tick(*l0, size, 4, 1100)),
        "fused_level_tick L1": C.device_ms(
            lambda: ft.fused_level_tick(*l1, size, 4, 1100)),
        "fused_select": C.device_ms(lambda: ft.fused_select(*sel)),
        "quantile_compact": C.device_ms(qc_all) / len(qc),
        **sums, **stats,
    }


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--measure":
        print(json.dumps(measure(Path(sys.argv[2]),
                                 json.loads(sys.argv[3]))))
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    import repro_torch as P

    qr = P.resolve(C.tenant_spec(P))
    shapes = json.dumps(C.compact_shapes(qr.plan, qr.capacities[-1]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    other = Path(sys.argv[1]).resolve()
    for tree in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, __file__, "--measure",
                              str(tree), shapes], capture_output=True,
                             text=True)
        if out.returncode != 0:
            sys.exit(f"kernel_ab: {tree} failed:\n{out.stderr[-3000:]}")
        print(out.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    main()
