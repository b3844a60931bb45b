"""The least a launch costs on a CUDA card: the floor under every kernel
of the port whose work is a few microseconds or less.

    python3 tools/launch_floor.py

At ``sample_mask``'s level-0 and root grids (``chip_smoke.MASK_SHAPES``'
44,032 and 2,200 items at 512 items a CTA of 128 threads: 86 and 5
CTAs) it times

- ``empty``: a kernel that does nothing;
- ``load_store``: one global load and one store of its result a thread;

each by ``chip_smoke.device_ms`` (the median of profiler traces), and
each after a trivial predecessor (one empty CTA) as a span, from the
predecessor's end to the kernel's end (``chip_smoke.span_ms``, the pairs
queued behind a spin kernel): launched plainly and as a programmatic
dependent (``cudaLaunchKernelEx`` with programmatic stream
serialization, ``griddepcontrol.wait`` before the load). Both kernels
wait there in either launch, as ``sample_mask`` does.

It builds its kernels with the port's ``nvcc`` flags into ``build/`` and
prints the card's name and power limit, one line per grid and one JSON
line.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import _build  # noqa: E402

THREADS = 128
ITEMS_PER_CTA = 512      # sample_mask: 128 threads x 4 items

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void floor_predecessor() {}

__global__ void floor_empty() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void floor_load_store(const float* __restrict__ in,
                                 float* __restrict__ out) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = in[i] + 1.f;
}

// kind 0: the predecessor (one CTA of 32 threads); 1: floor_empty;
// 2: floor_load_store; each on `blocks` CTAs of `threads`, as a
// programmatic dependent when pdl != 0.
extern "C" int floor_launch(int kind, int blocks, int threads, int pdl,
                            const float* in, float* out,
                            cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kind == 0 ? 1 : blocks, 1, 1);
  cfg.blockDim = dim3(kind == 0 ? 32 : threads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  cudaError_t err;
  if (kind == 0) err = cudaLaunchKernelEx(&cfg, floor_predecessor);
  else if (kind == 1) err = cudaLaunchKernelEx(&cfg, floor_empty);
  else err = cudaLaunchKernelEx(&cfg, floor_load_store, in, out);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
"""


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe" / "liblaunch_floor.so"
    src = out.with_suffix(".cu")
    out.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.floor_launch.argtypes = [I, I, I, I, P, P, P]
    lib.floor_launch.restype = I
    return lib


def measure(dev) -> dict:
    """Build the probe and time it on ``dev``: per grid (``"L0 86 CTAs"``
    and ``"root 5 CTAs"``) the device ms of ``empty`` and ``load_store``
    and the spans ``<kernel> span`` (plain launch) and ``<kernel> span
    pdl`` after the predecessor."""
    import chip_smoke as C
    import torch

    lib = build()
    stream = _build.stream_of(torch.empty(0, device=dev))
    (l0, _), (root, _) = C.MASK_SHAPES[0], C.MASK_SHAPES[-1]
    grids = {f"{name} {math.ceil(m / ITEMS_PER_CTA)} CTAs":
             math.ceil(m / ITEMS_PER_CTA)
             for name, m in (("L0", l0), ("root", root))}
    out = {}
    for name, blocks in grids.items():
        src = torch.rand(blocks * THREADS, device=dev)
        dst = torch.empty_like(src)
        args = (_build.ptr(src), _build.ptr(dst), stream)

        def launch(kind, pdl, blocks=blocks, args=args):
            rc = lib.floor_launch(kind, blocks, THREADS, pdl, *args)
            if rc != 0:
                raise RuntimeError(f"launch_floor: CUDA error {rc}")

        row = {}
        for kind, kernel in ((1, "empty"), (2, "load_store")):
            row[kernel] = C.device_ms(lambda k=kind: launch(k, 0))
            for pdl in (0, 1):
                def pair(k=kind, p=pdl):
                    launch(0, 0)
                    launch(k, p)
                row[f"{kernel} span" + (" pdl" if pdl else "")] = C.span_ms(
                    pair, f"floor_{kernel}", back=1)
        torch.cuda.synchronize()
        if not torch.equal(dst, src + 1.0):
            raise RuntimeError("launch_floor: load_store wrote wrong values")
        out[name] = row
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("launch_floor: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    r = measure(torch.device("cuda", 0))
    print(card)
    for grid, row in r.items():
        print(f"{grid}: " + ", ".join(f"{k} {v:.5f} ms"
                                      for k, v in row.items()))
    print(json.dumps({"card": card, **r}))


if __name__ == "__main__":
    main()
