// Float segment sums in item order, on Hopper.
//
// Replaces no Pallas kernel: it is the card's version of the reference's
// scatter-add `jnp.zeros(S).at[seg].add(x)` (repro/core/sampling.py,
// stratum_stds; repro/core/error.py, stratum_moments; repro/core/queries.py,
// weighted_histogram; repro/core/tree.py, the SRS root histogram), which on
// the CPU adds each segment's items in item order. PyTorch's index_add_ on
// a CUDA tensor adds with float atomics in no fixed order, so its sums
// differ from the CPU's in the last bits and from run to run; a neyman
// allocation fed by such a sum can move a row.
//
// What it computes: out[r, s] = sum over i in item order of values[r, i]
// where seg[r, i] == s, starting from 0.0, one f32 add at a time: the
// order of the CPU's index_add_ and of the reference's scatter, so the
// result is bitwise theirs. Ids outside [0, S) match no segment and are
// dropped, as the scatter drops them.
//
// What bounds it on this card: each row is read once per segment (4 bytes
// of value and 4 of id per item and segment), so bytes in principle; at
// the path's sizes (a level of 4 x 11,008 items, 4 segments) it is the
// latency of the serial adds.
//
// What the design does about it: one warp per (row, segment). The warp
// reads its row in tiles of 8 x 32 items (coalesced, the tile's loads in
// flight together); a ballot per 32-item chunk marks the items of its
// segment, and each marked lane writes its value to the warp's slice of
// shared memory at its rank among the tile's marked items (the ballot's
// prefix count), so the slice holds the tile's items of the segment in
// item order. Lane 0 then adds them in that order: the only serial part
// is one shared-memory load and one f32 add per item of the segment.
// Ids come as int32 or int64, as the caller has them: an id outside
// [0, S) equals no segment and is skipped, and the tile's tail past M
// reads as -1. Built with -fmad=false; there is no multiply.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunks = 8;                // 32-item chunks per tile
constexpr int kTile = kChunks * 32;

// grid ceil(rows * S / 8), block 256: warp w handles (row w / S, seg w % S).
template <typename Id>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ values,
                   const Id* __restrict__ seg, int rows, int m, int S,
                   float* __restrict__ out) {
  __shared__ float matched[kWarpsPerBlock][kTile];
  const int warp_in_block = threadIdx.x >> 5;
  const int warp = blockIdx.x * kWarpsPerBlock + warp_in_block;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * S) return;           // whole warps exit together
  const int row = warp / S, s = warp % S;
  const float* v = values + (size_t)row * m;
  const Id* g = seg + (size_t)row * m;
  float* buf = matched[warp_in_block];
  const unsigned below = (1u << lane) - 1u;   // lanes before this one
  float acc = 0.f;
  for (int base = 0; base < m; base += kTile) {
    float x[kChunks];
    Id id[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = base + c * 32 + lane;
      x[c] = i < m ? v[i] : 0.f;
      id[c] = i < m ? g[i] : -1;
    }
    int n = 0;                             // the tile's matches so far
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const unsigned mask = __ballot_sync(kFull, id[c] == s);
      if (id[c] == s) buf[n + __popc(mask & below)] = x[c];
      n += __popc(mask);
    }
    __syncwarp();
    if (lane == 0) {
      for (int k = 0; k < n; ++k) acc = acc + buf[k];
    }
    __syncwarp();
  }
  if (lane == 0) out[(size_t)row * S + s] = acc;
}

template <typename Id>
int launch(const float* values, const Id* seg, int rows, int m, int S,
           float* out, cudaStream_t stream) {
  const int warps = rows * S;
  const int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_sum_kernel<Id><<<blocks, kThreads, 0, stream>>>(values, seg, rows,
                                                          m, S, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int segment_sum_launch(const float* values, const int32_t* seg, int rows,
                       int m, int S, float* out, cudaStream_t stream) {
  return launch(values, seg, rows, m, S, out, stream);
}

int segment_sum_launch_i64(const float* values, const int64_t* seg, int rows,
                           int m, int S, float* out, cudaStream_t stream) {
  return launch(values, seg, rows, m, S, out, stream);
}

}  // extern "C"
