"""The latency of one dependent f32 add on a CUDA card: the floor of any
sum that must come out in item order.

    python3 tools/fadd_chain.py

An item-order sum (``segment_sum``: bitwise the CPU's ``index_add_``) is
a left fold from 0.0, one f32 add after another, so no design can finish
a segment faster than its item count times this latency. The probe runs
one thread of one block and reads ``clock64`` (SM cycles) and
``%globaltimer`` (ns) around

- ``chain``: 16,384 ``add.rn.f32`` each on the result of the one before;
- ``fold``: the same chain fed from shared memory, four ``float4`` loads
  issued ahead of their sixteen adds, as ``csrc/segment_sum.cu`` folds a
  segment's run.

It builds its kernel with the port's ``nvcc`` flags into ``build/`` and
prints cycles and ns per add, the SM clock they imply, the card's name
and power limit, and one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

ADDS = 16384          # adds per timed chain
FOLD_ITEMS = 8192     # items of the shared-memory fold (32 KB)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// out: the chain's result; t: cycles and ns of the chain, then of the fold.
__global__ void probe(const float* in, int adds, int items, float* out,
                      long long* t) {
  __shared__ __align__(16) float buf[8192];
  for (int i = 0; i < items; ++i) buf[i] = in[2 + (i & 255)];
  __syncthreads();
  float acc = in[0];
  const float v = in[1];
  long long c0 = clock64();
  uint64_t g0 = global_ns();
  for (int i = 0; i < adds; i += 64) {
#pragma unroll
    for (int k = 0; k < 64; ++k)
      asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(acc) : "f"(v));
  }
  long long c1 = clock64();
  uint64_t g1 = global_ns();
  out[0] = acc;
  // The fold: four float4 loads of the next sixteen items are issued
  // before the sixteen adds of the current ones.
  const float4* p = reinterpret_cast<const float4*>(buf);
  float f = 0.f;
  float4 cur[4], nxt[4];
  long long c2 = clock64();
  uint64_t g2 = global_ns();
#pragma unroll
  for (int j = 0; j < 4; ++j) cur[j] = p[j];
  for (int i = 4; i <= items / 4; i += 4) {
    if (i < items / 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) nxt[j] = p[i + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f = f + cur[j].x; f = f + cur[j].y; f = f + cur[j].z; f = f + cur[j].w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
  }
  long long c3 = clock64();
  uint64_t g3 = global_ns();
  out[1] = f;
  t[0] = c1 - c0; t[1] = (long long)(g1 - g0);
  t[2] = c3 - c2; t[3] = (long long)(g3 - g2);
}

extern "C" int fadd_chain_run(const float* in, int adds, int items,
                              float* out, long long* t) {
  probe<<<1, 1>>>(in, adds, items, out, t);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}
"""


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe" / "libfadd_chain.so"
    src = out.with_suffix(".cu")
    out.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.fadd_chain_run.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.fadd_chain_run.restype = ctypes.c_int
    return lib


def measure(dev) -> dict:
    """Build and run the probe on ``dev``: cycles and ns per add of the
    chain (``add_cycles``, ``add_ns``) and of the fold (``fold_cycles``,
    ``fold_ns``), the best of 5 runs after a warm-up run."""
    import torch

    lib = build()
    inp = torch.cat([torch.tensor([0.0, 1e-3]),
                     torch.linspace(-1.0, 1.0, 256)]).to(dev)
    out = torch.zeros(2, device=dev)
    t = torch.zeros(4, dtype=torch.int64, device=dev)
    runs = []
    for _ in range(6):
        rc = lib.fadd_chain_run(_build.ptr(inp), ADDS, FOLD_ITEMS,
                                _build.ptr(out), _build.ptr(t))
        if rc != 0:
            raise RuntimeError(f"fadd_chain: CUDA error {rc}")
        runs.append(t.tolist())
    runs = runs[1:]
    return {"add_cycles": min(r[0] for r in runs) / ADDS,
            "add_ns": min(r[1] for r in runs) / ADDS,
            "fold_cycles": min(r[2] for r in runs) / FOLD_ITEMS,
            "fold_ns": min(r[3] for r in runs) / FOLD_ITEMS}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("fadd_chain: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    r = measure(torch.device("cuda", 0))
    print(card)
    print(f"dependent f32 add: {r['add_cycles']:.3f} cycles, "
          f"{r['add_ns']:.4f} ns ({ADDS} adds, best of 5; SM clock "
          f"{r['add_cycles'] / r['add_ns']:.3f} GHz)")
    print(f"fold from shared memory (float4 loads issued ahead): "
          f"{r['fold_cycles']:.3f} cycles, {r['fold_ns']:.4f} ns per item "
          f"({FOLD_ITEMS} items)")
    print(json.dumps({"card": card, **r}))


if __name__ == "__main__":
    main()
