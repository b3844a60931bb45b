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
//   The invariant: each bucket's weights are added one at a time, in item
//   order, starting from 0.0, as the plain version's index_add_ does on the
//   CPU; so no float atomics and no partial sums of a bucket combined
//   afterwards, and the result is bitwise the plain version's at every
//   shape. (The TPU kernel adds one-hot matmuls, in no fixed order.)
//   What the design does about it: one warp owns one (depth row, bucket),
//   as csrc/segment_sum.cu's warps own a segment, so the work spreads over
//   depth x width warps instead of one thread per bucket walking every
//   item. A block (8 warps: 8 buckets of one depth row) stages a tile of up
//   to 4,096 items in shared memory, each with its hashed bucket for the
//   block's row and its weight (the root's 2,200 items are one tile). Each
//   warp walks the tile in 32-item chunks: one ballot per chunk marks the
//   items of its bucket (four chunks' ballots taken together, so their
//   loads overlap), and the warp adds the marked weights in lane order
//   (the ballot's set bits, lowest first, chunk by chunk; every lane adds
//   the same broadcast loads, lane 0 writes). Tiles go in item order, so each
//   bucket's sum keeps item order at any M; the only serial work is one
//   shared load and one add per item of the warp's own bucket. At the
//   tenants' widths that is 4,096 warps in 512 blocks (width 1,024) and
//   1,024 in 128 blocks (256): eight warps a block, not 32, put the narrow
//   table on 128 SMs rather than 32. From 4,096 buckets a row a block has
//   32 warps, so each tile is staged a quarter as often. (A block-wide
//   stable sort of each tile by bucket was the alternative; the ballot
//   walk needs no sort and no scratch beyond the tile.)

// quantile_compact: for each of C rank targets t, the sum over slots i, in
// slot order from 0.0, of values[i] where cumw_prev[i] <= t < cumw[i]; a
// target that no interval holds gives +0.0, and so does a lone hit of
// -0.0 (0.0f + -0.0f is +0.0f).
//   The trap: the sketch builds cumw with the reference's blocked scan
//   (query/sketches.py blocked_cumsum), which can fall by an ulp at a
//   16-slot block boundary. Its intervals then do not partition [0, W): a
//   target in such a dip lies in two slots, and the plain version adds
//   both. A binary search over cumw (searchsorted + gather) returns one of
//   them, so it is not this function.
//   What bounds it on this card: neither bytes (12 per slot, 8 per
//   target) nor operations (each slot and each target looked at once) at
//   the path's sizes (P ~ 400-2,500 slots, C = 64-256 targets): launch
//   and the latency of one pass over the slots.
//   What the design does about it: the P x C membership tests are spread
//   over ceil(C / 4) blocks of 256 threads, four targets a block, every
//   thread testing a strided share of the slots against the block's four
//   targets held in registers (16, 32 and 64 blocks at C = 64, 128 and
//   256). A hit adds 1 to its target's hit count and folds its slot
//   into the target's lowest and highest hit index, all integer
//   shared-memory atomics (exact in any order; no float atomics). Then one
//   thread a target writes 0.0f for no hit, 0.0f + values[i] for one, and
//   for two or more walks the slots from the lowest to the highest hit in
//   slot order, adding each hit to 0.0f as the plain version's sum does.
//   Two hits sum alike in any order; for three or more, see PERF.md
//   (the plain version is a torch.sum whose order is the CPU's own).
//
// Built with -fmad=false like the other kernels; neither kernel multiplies.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCmsMaxThreads = 1024;   // 32 buckets per block, cms_update
constexpr int kTile = 4096;        // items staged per pass, cms_update
constexpr int kQcThreads = 256;    // threads per block, quantile_compact
constexpr int kQcTargets = 4;      // targets per block, quantile_compact
constexpr unsigned kFull = 0xffffffffu;

__constant__ uint32_t kMult[6] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                  0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Du};

// grid (ceil(width / W), depth), block 32 W: warp w of block (x, d) owns
// bucket W x + w of depth row d.
__global__ void __launch_bounds__(kCmsMaxThreads)
cms_update_kernel(const uint32_t* __restrict__ keys,
                  const float* __restrict__ weights, int m, int width,
                  int shift, float* __restrict__ out) {
  __shared__ int s_bucket[kTile];
  __shared__ float s_weight[kTile];
  const int d = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int mine = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
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
    for (int c = 0; c < n; c += 128) {     // four chunks' ballots at once
      unsigned hit[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = c + 32 * u + lane;
        hit[u] = __ballot_sync(kFull, i < n && s_bucket[i] == mine);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)          // their items, in order
        for (unsigned h = hit[u]; h; h &= h - 1)
          acc = acc + s_weight[c + 32 * u + __ffs(h) - 1];
    }
    __syncthreads();
  }
  if (lane == 0 && mine < width)
    out[static_cast<size_t>(d) * width + mine] = acc;
}

// grid ceil(C / kQcTargets), block kQcThreads: block x owns targets
// [kQcTargets x, kQcTargets (x + 1)).
__global__ void __launch_bounds__(kQcThreads)
quantile_compact_kernel(const float* __restrict__ values,
                        const float* __restrict__ cumw_prev,
                        const float* __restrict__ cumw,
                        const float* __restrict__ targets, int p, int c,
                        float* __restrict__ out) {
  __shared__ int s_hits[kQcTargets], s_first[kQcTargets],
      s_last[kQcTargets];
  const int k0 = blockIdx.x * kQcTargets;
  float t[kQcTargets];
#pragma unroll
  for (int j = 0; j < kQcTargets; ++j)   // NaN: a padding target hits nothing
    t[j] = k0 + j < c ? targets[k0 + j] : __int_as_float(0x7fc00000);
  if (threadIdx.x < kQcTargets) {
    s_hits[threadIdx.x] = 0;
    s_first[threadIdx.x] = INT_MAX;
    s_last[threadIdx.x] = -1;
  }
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < p; i += kQcThreads) {
    const float lo = __ldg(cumw_prev + i), hi = __ldg(cumw + i);
#pragma unroll
    for (int j = 0; j < kQcTargets; ++j) {
      if (lo <= t[j] && t[j] < hi) {
        atomicAdd(&s_hits[j], 1);
        atomicMin(&s_first[j], i);
        atomicMax(&s_last[j], i);
      }
    }
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j < kQcTargets && k0 + j < c) {
    const float tj = targets[k0 + j];
    const int hits = s_hits[j];
    float acc = 0.f;
    if (hits == 1) {
      acc = acc + values[s_first[j]];
    } else if (hits > 1) {            // in slot order, as the plain sum
      for (int i = s_first[j]; i <= s_last[j]; ++i)
        if (cumw_prev[i] <= tj && tj < cumw[i]) acc = acc + values[i];
    }
    out[k0 + j] = acc;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int cms_update_launch(const uint32_t* keys, const float* weights, int m,
                      int depth, int width, int shift, float* out,
                      cudaStream_t stream) {
  // 8 warps a block, 32 on tables of 4,096 buckets a row and more (there
  // are blocks enough to fill the card, and each stages the items once).
  const int warps = width >= 4096 ? 32 : 8;
  const dim3 grid((width + warps - 1) / warps, depth);
  cms_update_kernel<<<grid, warps * 32, 0, stream>>>(keys, weights, m, width,
                                                     shift, out);
  return static_cast<int>(cudaGetLastError());
}

int quantile_compact_launch(const float* values, const float* cumw_prev,
                            const float* cumw, const float* targets, int p,
                            int c, float* out, cudaStream_t stream) {
  const int blocks = (c + kQcTargets - 1) / kQcTargets;
  quantile_compact_kernel<<<blocks, kQcThreads, 0, stream>>>(
      values, cumw_prev, cumw, targets, p, c, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
