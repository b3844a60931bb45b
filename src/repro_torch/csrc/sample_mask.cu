// Threshold selection with per-item weights, on Hopper.
//
// Replaces repro/kernels/sample_mask/sample_mask.py:
//   sample_mask (body _kernel) -> sample_mask_kernel
//
// What it computes, per item k (stage 2 of the `pallas` sampler backend;
// stage 1, the per-stratum thresholds tau, is plain PyTorch):
//   keep[k] = valid[k] && u[k] >= tau[s[k]]
//   w[k]    = keep[k] ? W[s[k]] : 0
// with the stratum index taken as the plain version takes it: a negative
// index counts from the end (s + X), then it is clamped into [0, X).
// Every item tied at tau is kept (the `pallas` tie law); tau = -1 keeps
// every valid item of its stratum and tau = +2 none. A NaN priority is
// never kept (an ordered compare), and -0.0 against a tau of +0.0 is.
//
// What bounds it on this card: not its bytes. 9 bytes in per item (u, s,
// valid) and 5 out (keep, w), with tau and W a few dozen bytes: 0.62 MB
// at the path's largest launch (level 0 of the testbed flattened, 44,032
// items), 0.18 us at 3.35 TB/s. A launch on this card costs more than
// that whatever it does: tools/launch_floor.py reads 0.8 us for an empty
// grid and 1.0 us for one load and one store a thread, 2.1 us from the
// end of a predecessor to the end of such a kernel, 0.9 us as a
// programmatic dependent (H100 80GB HBM3, 700 W). So the kernel is bound
// by its launch and by its chain of dependent memory trips, and the
// design shortens both:
//
// - The item loads first. A thread issues the loads of its items before
//   anything waits, then reads tau and W where the strata point, through
//   the read-only path (__ldg): at X <= 16 a few lines that the first
//   items bring into L1, and no barrier. Staging tau and W in shared
//   memory behind one barrier, with the item loads in flight, was within
//   0.03 us at the path's X and 1.8x slower at X = 6,144, where every CTA
//   copies 48 KB.
// - Four items a thread, as vectors: a 16-byte load of u and of s, a
//   4-byte load of valid, a 4-byte store of keep and a 16-byte store of w.
//   CTAs of 128 threads spread level 0 over 86 SMs, in one wave. The
//   wrapper passes `vec = 0` when any of u, s, valid, keep and w is not
//   aligned for that (a view at a storage offset of 1-3 items); the same
//   kernel then takes each item alone, neighbouring threads on
//   neighbouring items. The last M mod 4 items go one by one in either
//   case. (Eight items a thread, and CTAs of 64 or 256 threads, were
//   slower.) This lands 0.3 us above the one-load-one-store floor.
// - A programmatic dependent launch (cudaLaunchKernelEx with programmatic
//   stream serialization): the grid is scheduled while the kernel before
//   it on the stream drains; griddepcontrol.wait, before the first read
//   of any input, holds it until that work's writes are visible. Without
//   the attribute the wait returns at once. It took about 1.1 us off the
//   span from tau's producer to the mask's end, with the calls queued on
//   the stream, and nothing off the kernel's own time. Under stream
//   capture the launch becomes a programmatic graph edge.
//
// TMA bulk copies and thread-block clusters buy nothing here: one
// streaming pass over 0.6 MB is all latency, and neither shortens it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 4;   // items a thread: one 16-byte vector of u, s, w

__device__ __forceinline__ uint8_t byte_of(uint32_t v, int i) {
  return static_cast<uint8_t>(v >> (8 * i));
}

// grid ceil(m / (kThreads * kItems)), block kThreads. Thread t of block b
// takes the items kItems (kThreads b + t) + i when vec != 0, else
// kThreads (kItems b + i) + t.
__global__ void __launch_bounds__(kThreads)
sample_mask_kernel(const float* __restrict__ u, const int* __restrict__ s,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ tau,
                   const float* __restrict__ weights, int m, int X, int vec,
                   uint8_t* __restrict__ keep, float* __restrict__ w_out) {
  // Every input is written by the work queued before this launch.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int first = vec ? q * kItems : blockIdx.x * kThreads * kItems
                                           + threadIdx.x;
  const int step = vec ? 1 : kThreads;
  const bool whole = vec && first + kItems <= m;
  float uk[kItems];
  int sk[kItems];
  uint32_t vk = 0;   // valid, one byte an item
  // 1. This thread's items, issued before anything waits.
  if (whole) {
    const float4 a = reinterpret_cast<const float4*>(u)[q];
    const int4 b = reinterpret_cast<const int4*>(s)[q];
    uk[0] = a.x; uk[1] = a.y; uk[2] = a.z; uk[3] = a.w;
    sk[0] = b.x; sk[1] = b.y; sk[2] = b.z; sk[3] = b.w;
    vk = reinterpret_cast<const uint32_t*>(valid)[q];
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = first + i * step;
      uk[i] = 0.f;
      sk[i] = 0;
      if (k < m) {
        uk[i] = u[k];
        sk[i] = s[k];
        vk |= static_cast<uint32_t>(valid[k]) << (8 * i);
      }
    }
  }
  // 2. The compare and the select, tau and W read where the strata point.
  float wk[kItems];
  uint32_t kk = 0;   // keep, one byte an item
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = min(max(sk[i] < 0 ? sk[i] + X : sk[i], 0), X - 1);
    const float t = __ldg(tau + j), wj = __ldg(weights + j);
    const bool kept = byte_of(vk, i) != 0 && uk[i] >= t;
    kk |= static_cast<uint32_t>(kept) << (8 * i);
    wk[i] = kept ? wj : 0.f;
  }
  // 3. The stores.
  if (whole) {
    reinterpret_cast<uint32_t*>(keep)[q] = kk;
    reinterpret_cast<float4*>(w_out)[q] =
        make_float4(wk[0], wk[1], wk[2], wk[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = first + i * step;
      if (k < m) {
        keep[k] = byte_of(kk, i);
        w_out[k] = wk[i];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sample_mask_launch(const float* u, const int* s, const uint8_t* valid,
                       const float* tau, const float* weights, int m, int X,
                       int vec, uint8_t* keep, float* w_out,
                       cudaStream_t stream) {
  const int per_block = kThreads * kItems;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + per_block - 1) / per_block, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, sample_mask_kernel, u, s, valid,
                                       tau, weights, m, X, vec, keep, w_out);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // extern "C"
