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
// What bounds it on this card: not bytes (8 per item, read once) but the
// chain of dependent adds. No other association gives the CPU's bits, so
// a segment of n items takes at least n times the latency of one f32 add
// (tools/fadd_chain.py measures it), whatever the design.
//
// What the design does about it: it keeps everything but that chain off
// the critical path. One CTA of 512 threads per row walks the row in
// chunks of 4,096 items:
// - loads: two staging slots in shared memory. Each thread starts
//   asynchronous copies (cp.async, 4 bytes a value and 4 or 8 an id;
//   rows start at any item, so not 16-byte vectors) of its 8 items of a
//   chunk, 32 consecutive items a warp round, all in flight together; the
//   next chunk's copies fly while this one is sorted and folded, and a
//   thread reads back only the items it copied itself;
// - a stable sort by segment in shared memory. First each item's rank
//   among the earlier items of its segment in its warp's slice: up to 32
//   segments, a round's lanes are grouped by one ballot per bit of the
//   segment (2 for 4 segments, 5 at most) and lane k keeps the warp's
//   running count of segment k in a register, so no shared memory is
//   touched; above 32, by __match_any_sync, with the counts in a row of
//   shared memory a warp.
//   Then one thread a segment turns the warps' counts into offsets in warp
//   order, a scan over the segments places their runs one after another
//   (each run starts on a 16-byte boundary), and each item is written at
//   its run's start plus its warp's offset plus its rank: each run holds
//   its segment's items in item order;
// - the fold: thread s adds its segment's run to its accumulator, which
//   carries over the chunks, one f32 add an item, the next 16 items'
//   float4 loads issued before the current 16 adds.
// Segments are taken 256 at a time (a window); a row with more segments
// is walked once per window. Ids come as int32 or int64, as the caller
// has them, and are compared in their own type. Built with -fmad=false;
// there is no multiply.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                  // 32-item rounds a warp a chunk
constexpr int kSlice = kRounds * 32;        // items of a warp's slice
constexpr int kChunk = kWarps * kSlice;     // items of a chunk
constexpr int kWindow = 256;                // segments a pass over the row
constexpr unsigned kFull = 0xffffffffu;

// Phase timestamps for tools/sum_phases.py: built with
// -DREPRO_PHASE_PROBE, thread 0 of each CTA writes %globaltimer (ns, the
// same clock on every SM) and clock64 (its SM's cycles) at the end of
// each phase to the buffer that segment_sum_set_probe names, after a
// block barrier (so the probe build runs a little longer than the kernel
// it measures).
constexpr int kProbeSlots = 32;
#ifdef REPRO_PHASE_PROBE
__device__ long long* g_probe;
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE(slot)                                                     \
  do {                                                                  \
    __syncthreads();                                                    \
    if (threadIdx.x == 0 && g_probe != nullptr && (slot) < kProbeSlots) { \
      long long* p_ = g_probe + 2 * (blockIdx.x * kProbeSlots + (slot)); \
      p_[0] = global_ns();                                              \
      p_[1] = clock64();                                                \
    }                                                                   \
  } while (0)
#else
#define PROBE(slot) \
  do {              \
  } while (0)
#endif

// Shared memory (bytes) for a window of w segments: two staging slots of
// a chunk's ids and values, the sorted chunk (runs padded to 4 items), the
// warps' rows of counts and then places, the block scan's warp totals.
template <typename Id>
constexpr size_t smem_bytes(int w) {
  return 2 * (size_t)kChunk * (sizeof(Id) + sizeof(float)) +
         sizeof(float) * ((size_t)kChunk + 4 * w + kWarps * w + kWarps);
}

__device__ __forceinline__ void add4(float& acc, const float4 v) {
  acc = acc + v.x;
  acc = acc + v.y;
  acc = acc + v.z;
  acc = acc + v.w;
}

// acc + p[0] + p[1] + ... + p[n - 1], left to right; p is 16-byte aligned.
__device__ __forceinline__ float fold(const float* p, int n, float acc) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const int n4 = n >> 2;
  int i = 0;
  if (n4 >= 4) {
    float4 cur[4], nxt[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = q[j];
    for (i = 4; i + 4 <= n4; i += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) nxt[j] = q[i + j];
#pragma unroll
      for (int j = 0; j < 4; ++j) add4(acc, cur[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) add4(acc, cur[j]);
  }
  for (; i < n4; ++i) add4(acc, q[i]);
  for (int k = n4 * 4; k < n; ++k) acc = acc + p[k];
  return acc;
}

// Inclusive sum of v over the warp's lanes.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

// Start copying this thread's items of the chunk at base into staging
// slot `slot` (nothing past m), as one group of asynchronous copies.
template <typename Id>
__device__ __forceinline__ void stage_chunk(const float* v, const Id* g,
                                            int m, int base, int slot,
                                            int warp, int lane, float* sv,
                                            Id* sid) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = warp * kSlice + r * 32 + lane;
    if (base + k < m) {
      cp_async(sv + slot * kChunk + k, v + base + k, 4);
      cp_async(sid + slot * kChunk + k, g + base + k, (int)sizeof(Id));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// grid rows, block kThreads, dynamic shared memory smem_bytes<Id>(win).
template <typename Id>
__global__ void __launch_bounds__(kThreads, 1)
segment_sum_kernel(const float* __restrict__ values,
                   const Id* __restrict__ seg, int m, int S, int win,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Id* sid = reinterpret_cast<Id*>(smem);                  // [2][kChunk]
  float* sv = reinterpret_cast<float*>(sid + 2 * kChunk);  // [2][kChunk]
  float* sorted = sv + 2 * kChunk;
  int* hist = reinterpret_cast<int*>(sorted + kChunk + 4 * win);
  int* wsum = hist + kWarps * win;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const float* v = values + (size_t)blockIdx.x * m;
  const Id* g = seg + (size_t)blockIdx.x * m;
  int* mine = hist + warp * win;          // this warp's row
  // Up to 32 segments a window, a key's bits (nb of them) are enough to
  // group a round's lanes by ballots, and lane k counts segment k.
  const bool narrow = win <= 32;
  const int nb = 32 - __clz(win - 1);
  PROBE(0);
  for (int lo = 0; lo < S; lo += win) {
    const int hi = min(lo + win, S);
    float acc = 0.f;
    stage_chunk(v, g, m, 0, 0, warp, lane, sv, sid);
    stage_chunk(v, g, m, kChunk, 1, warp, lane, sv, sid);
    for (int base = 0, c = 0; base < m; base += kChunk, ++c) {
      // This chunk's copies are in (the next chunk's may still fly); each
      // thread reads only the items it copied itself.
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      float x[kRounds];
      Id id[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int k = warp * kSlice + r * 32 + lane;
        x[r] = base + k < m ? sv[(c & 1) * kChunk + k] : 0.f;
        id[r] = base + k < m ? sid[(c & 1) * kChunk + k] : Id(-1);
      }
      // 1. Each item's rank among the earlier items of its segment in its
      // warp's slice, and the warp's count of each segment in its row.
      int key[kRounds], rank[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int i = base + warp * kSlice + r * 32 + lane;
        const bool ok = i < m && id[r] >= Id(lo) && id[r] < Id(hi);
        key[r] = ok ? (int)(id[r] - Id(lo)) : -1;
      }
      if (narrow) {
        int cnt = 0;  // lane k: the warp's count of segment k so far
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          unsigned peers = __ballot_sync(kFull, key[r] >= 0);
          unsigned own = lane < win ? peers : 0u;
          for (int b = 0; b < nb; ++b) {
            const unsigned bit = __ballot_sync(kFull, (key[r] >> b) & 1);
            peers &= (key[r] >> b) & 1 ? bit : ~bit;
            own &= (lane >> b) & 1 ? bit : ~bit;
          }
          rank[r] = __shfl_sync(kFull, cnt, key[r] & 31) +
                    __popc(peers & below);
          cnt += __popc(own);
        }
        if (lane < win) mine[lane] = cnt;
      } else {
        for (int k = lane; k < win; k += 32) mine[k] = 0;
        __syncwarp();
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          const bool ok = key[r] >= 0;
          const unsigned peers = __match_any_sync(kFull, key[r]);
          const int before = ok ? mine[key[r]] : 0;
          __syncwarp();
          if (ok && lane == __ffs(peers) - 1)
            mine[key[r]] = before + __popc(peers);
          __syncwarp();
          rank[r] = before + __popc(peers & below);
        }
      }
      __syncthreads();
      if (lo == 0) PROBE(1 + 4 * c);
      // 2. Thread k < win (warp 0 for a narrow window): its segment's count
      // n, the run's start (runs one after another, each padded to 4
      // items), and in row w of hist where warp w's first item of the
      // segment goes.
      int off[kWarps];
      int n = 0, my_start = 0;
      if (tid < win) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) off[w] = hist[w * win + tid];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int t = off[w];
          off[w] = n;
          n += t;
        }
      }
      const int padded = (n + 3) & ~3;
      if (narrow) {
        if (warp == 0) my_start = warp_scan(padded, lane) - padded;
      } else {
        const int incl = warp_scan(padded, lane);
        if (lane == 31) wsum[warp] = incl;
        __syncthreads();
        if (warp == 0) {
          const int t = lane < kWarps ? wsum[lane] : 0;
          const int e = warp_scan(t, lane) - t;
          if (lane < kWarps) wsum[lane] = e;
        }
        __syncthreads();
        my_start = wsum[warp] + incl - padded;
      }
      if (tid < win) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          hist[w * win + tid] = my_start + off[w];
      }
      __syncthreads();
      if (lo == 0) PROBE(2 + 4 * c);
      // 3. The stable sort: each item at its warp's place in its run plus
      // its rank.
      int pos[kRounds];  // all places read before any item is written
#pragma unroll
      for (int r = 0; r < kRounds; ++r)
        pos[r] = key[r] >= 0 ? mine[key[r]] + rank[r] : -1;
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if (pos[r] >= 0) sorted[pos[r]] = x[r];
      }
      __syncthreads();
      if (lo == 0) PROBE(3 + 4 * c);
      // 4. The fold, in item order.
      if (tid < hi - lo) acc = fold(sorted + my_start, n, acc);
      __syncthreads();  // the next chunk rewrites sorted and hist
      if (lo == 0) PROBE(4 + 4 * c);
      stage_chunk(v, g, m, base + 2 * kChunk, c & 1, warp, lane, sv, sid);
    }
    if (tid < hi - lo) out[(size_t)blockIdx.x * S + lo + tid] = acc;
  }
  PROBE(kProbeSlots - 1);
}

template <typename Id>
int launch(const float* values, const Id* seg, int rows, int m, int S,
           float* out, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_sum_kernel<Id>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<Id>(kWindow));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int win = S < kWindow ? S : kWindow;
  segment_sum_kernel<Id><<<rows, kThreads, smem_bytes<Id>(win), stream>>>(
      values, seg, m, S, win, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef REPRO_PHASE_PROBE
int segment_sum_set_probe(long long* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, &buf, sizeof(buf)));
}

int segment_sum_probe_slots() { return kProbeSlots; }
#endif

int segment_sum_launch(const float* values, const int32_t* seg, int rows,
                       int m, int S, float* out, cudaStream_t stream) {
  return launch(values, seg, rows, m, S, out, stream);
}

int segment_sum_launch_i64(const float* values, const int64_t* seg, int rows,
                           int m, int S, float* out, cudaStream_t stream) {
  return launch(values, seg, rows, m, S, out, stream);
}

}  // extern "C"
