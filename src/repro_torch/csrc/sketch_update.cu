// The two sketch-update passes of the standing-query plane, on Hopper.
//
// Replaces repro/kernels/sketch_update/sketch_update.py:
//   cms_update       (body _cms_kernel)     -> cms_update_kernel
//   quantile_compact (body _compact_kernel) -> quantile_compact_kernel
//
// cms_update: the weighted count-min delta f32[depth, width] of a key
// batch, with the multiply-shift hash h_d(k) = (A[d]*k mod 2^32) >>
// (32 - log2 width).
//   What bounds it on this card: neither bytes (8 bytes read per item,
//   4 written per bucket) nor arithmetic at the root's size (M = 2,200
//   items, depth 4): it is one short pass whose cost is its launch and the
//   latency of walking the items in order.
//   What the design does about it: the TPU kernel adds one-hot matmuls,
//   which sum a bucket's weights in no fixed order. Here every bucket is
//   owned by one thread (block = one depth row and a chunk of up to 1,024
//   buckets, thread = one bucket), the items are staged through shared
//   memory in tiles with their hashed buckets, and each thread walks the
//   tile in item order, adding the weights that fall in its bucket to a
//   register. So each bucket's weights are added in item order, as the
//   plain version's index_add_ does on the CPU, with no float atomics:
//   the result is bitwise the plain version's at every shape.
//
// quantile_compact: for each of C rank targets, the sum of the values of
// the slots whose weight interval [cumw_prev, cumw) holds it (one slot at
// most when the intervals partition [0, W), as the caller's do); a target
// at or past W gives 0.
//   What bounds it on this card: the P x C membership tests (P ~ 2,456
//   slots, C = 128 at the root's level-0 fold): about 3e5 compares, far
//   below a microsecond of the card's rate; bytes are 12 per slot. Like
//   cms_update it is launch- and latency-bound at these sizes.
//   What the design does about it: one thread per target, the slots
//   staged through shared memory in tiles, each thread walking every slot
//   in order with the plain version's membership rule (not a binary
//   search, so the two agree on any input, not only on sorted ones).
//
// Built with -fmad=false like the other kernels; neither kernel multiplies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;     // buckets per block, cms_update
constexpr int kTile = 1024;        // items staged per pass, cms_update
constexpr int kTargets = 256;      // targets per block, quantile_compact
constexpr int kSlots = 1024;       // slots staged per pass, quantile_compact

__constant__ uint32_t kMult[6] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                  0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Du};

// grid (ceil(width / 1024), depth), block min(width, 1024).
__global__ void __launch_bounds__(kThreads)
cms_update_kernel(const uint32_t* __restrict__ keys,
                  const float* __restrict__ weights, int m, int width,
                  int shift, float* __restrict__ out) {
  __shared__ int s_bucket[kTile];
  __shared__ float s_weight[kTile];
  const int d = blockIdx.y;
  const int mine = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t mult = kMult[d];
  float acc = 0.f;
  for (int base = 0; base < m; base += kTile) {
    const int n = min(kTile, m - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t h = keys[base + i] * mult;
      s_bucket[i] = shift < 32 ? static_cast<int>(h >> shift) : 0;
      s_weight[i] = weights[base + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (s_bucket[i] == mine) acc = acc + s_weight[i];
    }
    __syncthreads();
  }
  if (mine < width) out[static_cast<size_t>(d) * width + mine] = acc;
}

// grid ceil(C / 256), block 256.
__global__ void __launch_bounds__(kTargets)
quantile_compact_kernel(const float* __restrict__ values,
                        const float* __restrict__ cumw_prev,
                        const float* __restrict__ cumw,
                        const float* __restrict__ targets, int p, int c,
                        float* __restrict__ out) {
  __shared__ float s_v[kSlots], s_lo[kSlots], s_hi[kSlots];
  const int k = blockIdx.x * kTargets + threadIdx.x;
  const float t = k < c ? targets[k] : 0.f;
  float acc = 0.f;
  for (int base = 0; base < p; base += kSlots) {
    const int n = min(kSlots, p - base);
    for (int i = threadIdx.x; i < n; i += kTargets) {
      s_v[i] = values[base + i];
      s_lo[i] = cumw_prev[base + i];
      s_hi[i] = cumw[base + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (s_lo[i] <= t && t < s_hi[i]) acc = acc + s_v[i];
    }
    __syncthreads();
  }
  if (k < c) out[k] = acc;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int cms_update_launch(const uint32_t* keys, const float* weights, int m,
                      int depth, int width, int shift, float* out,
                      cudaStream_t stream) {
  const int threads = width < kThreads ? width : kThreads;
  const dim3 grid((width + threads - 1) / threads, depth);
  cms_update_kernel<<<grid, threads, 0, stream>>>(keys, weights, m, width,
                                                  shift, out);
  return static_cast<int>(cudaGetLastError());
}

int quantile_compact_launch(const float* values, const float* cumw_prev,
                            const float* cumw, const float* targets, int p,
                            int c, float* out, cudaStream_t stream) {
  const int blocks = (c + kTargets - 1) / kTargets;
  quantile_compact_kernel<<<blocks, kTargets, 0, stream>>>(
      values, cumw_prev, cumw, targets, p, c, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
