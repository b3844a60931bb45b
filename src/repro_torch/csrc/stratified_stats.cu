// Per-stratum (count, sum x, sum x^2) over masked items, on Hopper.
//
// Replaces repro/kernels/stratified_stats/stratified_stats.py:
//   stratified_stats (body _kernel) -> stratified_stats_partial + _final
//
// What bounds it on this card: device memory in principle (9 bytes read
// per item, 12 bytes written per stratum), but at the root's size (2,200
// items) the two launches' fixed cost dominates by far.
//
// What the design does about it: the TPU kernel walks item tiles in order
// and accumulates one-hot matmuls into one output block. Blocks on the
// card run in no order, so each block here reduces a tile of 2,048 items
// to per-stratum partials (registers, then a fixed shuffle tree, then the
// warps in order) and a second pass adds the partials in block order, one
// thread per stratum. The strata are taken 32 at a time (the shared
// staging holds 32), so any number of them works, at a cost that grows
// with it; a stratum's sums are added in the same order whatever their
// number. Counts are integers, so exact; the float sums are the same from
// run to run because no float is added with an atomic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;                // strata staged per pass
constexpr int kThreads = 256;
constexpr int kItems = 8;                 // per thread
constexpr int kTile = kThreads * kItems;  // TILE in ops.py
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
stratified_stats_partial(const float* __restrict__ values,
                         const int* __restrict__ strata,
                         const uint8_t* __restrict__ mask, int m, int X,
                         float* sums, int* cnts) {
  __shared__ float ws1[kWarps][kChunk], ws2[kWarps][kChunk];
  __shared__ int wc[kWarps][kChunk];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kTile;
  float xv[kItems];
  int xs[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = base + j * kThreads + tid;
    const bool ok = k < m && mask[k];
    xv[j] = ok ? values[k] : 0.f;
    xs[j] = ok ? strata[k] : -1;
  }
  for (int s0 = 0; s0 < X; s0 += kChunk) {
    const int n = min(kChunk, X - s0);
    for (int q = 0; q < n; ++q) {
      const int s = s0 + q;
      float a = 0.f, b = 0.f;
      int c = 0;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (xs[j] == s) {
          a = a + xv[j];
          b = b + xv[j] * xv[j];
          ++c;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        a = a + __shfl_down_sync(kFull, a, off);
        b = b + __shfl_down_sync(kFull, b, off);
        c += __shfl_down_sync(kFull, c, off);
      }
      if (lane == 0) {
        ws1[warp][q] = a;
        ws2[warp][q] = b;
        wc[warp][q] = c;
      }
    }
    __syncthreads();
    if (tid < n) {
      float a = 0.f, b = 0.f;
      int c = 0;
      for (int w = 0; w < kWarps; ++w) {
        a = a + ws1[w][tid];
        b = b + ws2[w][tid];
        c += wc[w][tid];
      }
      const size_t o = (size_t)blockIdx.x * X + s0 + tid;
      sums[2 * o] = a;
      sums[2 * o + 1] = b;
      cnts[o] = c;
    }
    __syncthreads();
  }
}

// grid ceil(X / 256), block 256: one thread per stratum.
__global__ void stratified_stats_final(const float* __restrict__ sums,
                                       const int* __restrict__ cnts,
                                       int blocks, int X, float* out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= X) return;
  float a = 0.f, b = 0.f;
  int c = 0;
  for (int blk = 0; blk < blocks; ++blk) {
    const size_t o = (size_t)blk * X + s;
    a = a + sums[2 * o];
    b = b + sums[2 * o + 1];
    c += cnts[o];
  }
  out[3 * s] = (float)c;
  out[3 * s + 1] = a;
  out[3 * s + 2] = b;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int stratified_stats_launch(const float* values, const int* strata,
                            const uint8_t* mask, int m, int X, float* sums,
                            int* cnts, float* out, cudaStream_t stream) {
  const int blocks = m > 0 ? (m + kTile - 1) / kTile : 1;
  stratified_stats_partial<<<blocks, kThreads, 0, stream>>>(
      values, strata, mask, m, X, sums, cnts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stratified_stats_final<<<(X + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(sums, cnts, blocks, X, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
