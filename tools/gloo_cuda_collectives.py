"""Which collectives gloo runs on CUDA tensors, one at a time.

Two gloo ranks share ``cuda:0``; each collective that DTensor issues
(``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, as ``torch.ops._c10d_functional`` calls them) runs
in its own pair of rank processes, so one that crashes a rank does not
hide the others. Prints one line per collective: ``ok`` with the result
checked against the sum/concatenation it should give, or how it failed.
The model mesh (``repro_torch.launch.mesh.collectives``) stages every
collective of gloo ranks on a card through the host whatever this
prints.

    python3 tools/gloo_cuda_collectives.py
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_to_all_single")

_RANK = r"""
import sys, torch, torch.distributed as dist
op, rank, n, init = sys.argv[1], int(sys.argv[2]), 2, sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=n)
F = torch.ops._c10d_functional
g = dist.group.WORLD.group_name
x = torch.arange(8, dtype=torch.float32, device="cuda") + 100 * rank
every = [torch.arange(8.0) + 100 * r for r in range(n)]
if op == "all_reduce":
    got, want = F.all_reduce(x, "sum", g), sum(every)
elif op == "all_gather_into_tensor":
    got, want = F.all_gather_into_tensor(x, n, g), torch.cat(every)
elif op == "reduce_scatter_tensor":
    got, want = F.reduce_scatter_tensor(x, "sum", n, g), sum(every)[
        rank * 4:(rank + 1) * 4]
else:
    got = F.all_to_all_single(x, [4] * n, [4] * n, g)
    want = torch.cat([e[rank * 4:(rank + 1) * 4] for e in every])
got = F.wait_tensor(got)
torch.cuda.synchronize()
assert torch.equal(got.cpu(), want), (got, want)
dist.destroy_process_group()
"""


def probe(op: str) -> str:
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "rdv")
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, op, str(r),
                                   init], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                out = "timed out"
            outs.append((p.returncode, out))
    if all(rc == 0 for rc, _ in outs):
        return "ok"
    rc, out = next((rc, o) for rc, o in outs if rc != 0)
    last = [ln for ln in out.strip().splitlines() if ln.strip()][-1:] or [""]
    return f"fails (exit {rc}): {last[0][:160]}"


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}")
    for op in OPS:
        print(f"gloo on CUDA tensors, {op}: {probe(op)}", flush=True)


if __name__ == "__main__":
    main()
