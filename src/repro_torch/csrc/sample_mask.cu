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
// every valid item of its stratum and tau = +2 none.
//
// What bounds it on this card: device memory. 9 bytes in per item (u, s,
// valid) and 5 out (keep, w): 14 bytes, with tau and W a few dozen bytes.
// At the path's largest launch (level 0 of the testbed flattened, 44,032
// items) that is 0.62 MB, a fraction of a microsecond at 3.35 TB/s, so
// the launch itself costs more than the work.
//
// What the design does about it: the TPU kernel resolves tau and W with a
// one-hot matmul because a gather is serial there; on the card a gather
// from shared memory is cheap. Each block stages tau and W in shared
// memory, then one thread per item does the compare and writes a byte and
// a float; neighbouring threads touch neighbouring items, so every load
// and store is coalesced. Padding slots, whose strata are arbitrary, read
// an in-bounds entry after the wrap and clamp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// grid ceil(m / 256), block 256, dynamic shared memory 2 * X floats.
__global__ void __launch_bounds__(kThreads)
sample_mask_kernel(const float* __restrict__ u, const int* __restrict__ s,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ tau,
                   const float* __restrict__ weights, int m, int X,
                   uint8_t* __restrict__ keep, float* __restrict__ w_out) {
  extern __shared__ float table[];        // tau[0, X), then W[0, X)
  for (int j = threadIdx.x; j < X; j += blockDim.x) {
    table[j] = tau[j];
    table[X + j] = weights[j];
  }
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= m) return;
  const int sk = s[k];
  const int j = min(max(sk < 0 ? sk + X : sk, 0), X - 1);
  const bool kept = valid[k] != 0 && u[k] >= table[j];
  keep[k] = kept ? 1 : 0;
  w_out[k] = kept ? table[X + j] : 0.f;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sample_mask_launch(const float* u, const int* s, const uint8_t* valid,
                       const float* tau, const float* weights, int m, int X,
                       uint8_t* keep, float* w_out, cudaStream_t stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  const size_t smem = 2 * (size_t)X * sizeof(float);
  sample_mask_kernel<<<blocks, kThreads, smem, stream>>>(
      u, s, valid, tau, weights, m, X, keep, w_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
