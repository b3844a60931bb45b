// The whole WHS tick of one hierarchy level, and selection alone, on Hopper.
//
// Replaces repro/kernels/fused_level_tick/fused_level_tick.py:
//   fused_level_tick (body _kernel)        -> fused_level_tick_kernel
//   fused_select     (body _select_kernel) -> fused_select_kernel
//
// What bounds it on this card: not bytes (13 bytes a slot in, some out)
// and not arithmetic, but the chain of dependent steps over a node's
// buffer: the counts, then the allocation, then the threshold tau of each
// stratum, then the strict keeps and the ties, then the compaction. The
// reference's TPU kernel finds tau by 31 rounds of bisection, each a pass
// over the buffer; one block per node walking them (the first port) put
// level 0 of the paper's testbed on 4 SMs for some 35 barrier-separated
// passes.
//
// What the design does about it:
// - One thread-block cluster of kMaxCluster CTAs per node (the wrapper's
//   CLUSTER; tools/fused_tick_phases.py sweeps 1-8), launched with
//   cudaLaunchKernelEx and a cluster attribute. CTA r takes the r-th
//   contiguous slice of the node's buffer; each pass over it reads the
//   slice from L1. Per-stratum counts are warp-aggregated integer
//   shared-memory atomics, exact in any order; CTAs exchange them through
//   distributed shared memory (DSMEM) between cluster barriers.
// - tau by radix select, most significant digit first, on the priority's
//   31 bits below the sign: each CTA histograms the digit of its eligible
//   items (valid, stratum in [0, X), sign bit clear, higher digits equal
//   to the prefix found so far) per stratum and adds its nonzero bins into
//   every CTA's merged histogram with remote atomics that no one waits
//   for; after the cluster barrier each CTA picks, per stratum, the digit
//   that holds the n_eff-th largest. Digits of 8 bits take 4 passes
//   instead of 31; the two histogram buffers (X * 2^b words each) and five
//   per-stratum arrays share kSmemWords, so b narrows as X grows
//   (digit_bits). The result is the n_eff-th largest eligible bit pattern
//   clamped to 1.0f's, or 0 when fewer than n_eff are eligible: bit for
//   bit the bisection's lo, the largest pattern in [0, 0x3F800000] with
//   count(u_bits >= lo) >= n_eff. The special cases stay: N <= 0 gives
//   tau = 2.0, c <= N gives tau = -1.0.
// - Strict keeps (u > tau) and ties (u == tau) are counted per CTA and
//   stratum in one pass. From every CTA's counts each CTA derives the
//   slack N - strict, its ties' first rank (the ties of earlier CTAs, in
//   rank order), and the keeps of the CTAs before it, so buffer order,
//   the tie law and the compacted order stay as the plain version's.
//   Within a CTA a block scan lists its ties in buffer order and one warp
//   ranks only them (match_any per 32 ties); a second block scan places
//   each kept item. No pass over the whole buffer is serial.
// - The allocation and the Alg. 2 lines 12-20 + Eq. 9 weight update run
//   on one thread of rank 0 with the same f32 operations in the same
//   order as repro_torch/core/sampling.py and repro_torch/core/whs.py; the
//   file is built with -fmad=false so that no multiply-add is contracted.
//   Up to kRegStrata strata its per-stratum arrays are registers (the
//   loops unrolled), above they live in a per-node global scratch that
//   the wrapper allocates (kScratchArrays words a stratum), beside an int
//   per slot for the tie lists.
// - The neyman moments (each stratum's sum of v and of v*v over its valid
//   items, in buffer order, bitwise the plain version's item-order
//   scatter) run on rank 0's CTA between the first two cluster barriers.
//   Each sum is a chain of dependent f32 adds, so the phase's floor is
//   the largest stratum's item count times one add's latency
//   (tools/fadd_chain.py: about 2.05 ns). It walks only the slots up to
//   the node's last valid one, in tiles: 8 partition warps stage a tile
//   (cp.async, 16-byte chunks, two slots) and sort it stably by stratum
//   in shared memory (ranks by ballots up to 32 strata a window, by
//   __match_any_sync above, then a scan over the strata), while a pair of
//   fold warps on two other schedulers folds the tile before: lane s of
//   one adds stratum s's run of values, of the other their squares. Named
//   barriers hand the two sorted tiles back and forth. Strata go 32 a
//   pair (up to 4 pairs), in windows of that many. The phase's shared
//   memory sits after the state and is requested for neyman only; the
//   tile shrinks where the state leaves less room (stds_plan). The phase
//   is its own instantiation of the kernel (kMoments), so the other
//   policies run the kernel's code without it.
// What is left (tools/fused_tick_phases.py): seven cluster barriers of
// about 0.85 us each, the allocation's thread, and per digit a histogram,
// the remote adds and the choice, each a dependent step of well under a
// microsecond; the passes over the slots are a small part at the
// testbed's sizes. With neyman, the moments' chain comes first.
//
// Tie law: items with u > tau are kept; items with u == tau (exact f32
// ties) are kept in buffer order while their rank within the stratum is at
// most N - (strict keeps). This is the stable lexsort's law, so masks equal
// the argsort reference bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxStrata = 4096;
constexpr int kMaxCluster = 8;      // CTAs per node at most: the portable size
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrioBits = 31;       // a priority's bits below the sign
constexpr int kTauMax = 0x3F800000; // bits of 1.0f: the bisection's top
constexpr int kStateArrays = 5;     // per-stratum words beside the histograms
constexpr int kSmemWords = 53248;   // 208 KB of dynamic shared memory at most

enum Policy { kFair = 0, kProportional = 1, kNeyman = 2 };

// Bits per radix digit at X strata: 8 where the two histogram buffers fit
// beside the per-stratum arrays, fewer as X grows (2 at X = 4,096).
__host__ __device__ inline int digit_bits(int X) {
  int b = 8;
  while (b > 2 && (kStateArrays + 2 * (1 << b)) * X > kSmemWords) --b;
  return b;
}

// Digits of tau's search at b bits a digit: passes over a node's slots
// when some reservoir is short of its count (the first in the count pass).
__host__ __device__ inline int radix_passes(int b) {
  return (kPrioBits + b - 1) / b;
}

// Per-CTA state, carved from dynamic shared memory; the arrays that other
// CTAs read or add to over DSMEM are marked (remote).
struct State {
  int X, B, cs;  // strata, bins a stratum and digit, CTAs in the cluster
  int* cnt;    // this CTA's valid count per stratum, then its strict
               // keeps per stratum (remote)
  int* ties;   // (int)N during the search, then this CTA's ties (remote)
  int* pre;    // tau's bits found so far, then tau (as float bits)
  int* kk;     // the rank still to find (0: search over), then the slack
               // (as float bits)
  int* carry;  // (int)c during the search, then the ties of this stratum
               // in earlier CTAs
  int* hist[2];  // digit histograms, X * B words each (remote)
};

// The two histograms, then the five per-stratum arrays.
__device__ __forceinline__ State carve(int X, int b) {
  extern __shared__ int dyn[];
  const int B = 1 << b;
  const int cs = (int)cg::this_cluster().num_blocks();
  int* rest = dyn + 2 * X * B;
  return State{X,        B,         cs,       rest,
               rest + X, rest + 2 * X, rest + 3 * X, rest + 4 * X,
               {dyn, dyn + X * B}};
}

struct Fixed {
  int wsum[kWarps + 1];  // block reductions and scans
  int nv, last;          // this CTA's valid items, last valid position (remote)
  int strict_total;      // this CTA's strict keeps, any stratum (remote)
  int saturated;         // rank 0: every reservoir covers its count (remote)
  int sum_before, sum_all, max_all;  // gather_scalar's results
};


// The allocation thread's per-stratum arrays, in the node's slice of the
// global scratch (kScratchArrays * X floats).
constexpr int kScratchArrays = 16;
enum ScratchArray {
  kAlloc = 0, kActive, kReserve, kRemCounts, kOne, kPre, kQuota, kBase,
  kFrac, kScore, kS, kUsed, kCapped, kHead, kCounts, kStds
};

// Phase timestamps for tools/fused_tick_phases.py: built with
// -DREPRO_PHASE_PROBE, thread 0 of each CTA writes %globaltimer (ns, the
// same clock on every SM) at each phase's end to the buffer that
// fused_level_tick_set_probe names, after a block barrier (so the probe
// build runs a little longer than the kernel it measures).
constexpr int kProbeSlots = 32;
constexpr int kProbePasses = 6;  // passes with probes: slots 7 .. 24
constexpr int kProbeStds = 25;   // rank 0: the neyman moments' end
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
    if (threadIdx.x == 0 && g_probe != nullptr)                         \
      g_probe[blockIdx.x * kProbeSlots + (slot)] = global_ns();         \
  } while (0)
#else
#define PROBE(slot) \
  do {              \
  } while (0)
#endif

__device__ __forceinline__ int clamp_stratum(int s, int X) {
  return s < 0 ? 0 : (s >= X ? X - 1 : s);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

template <class T>
__device__ __forceinline__ T* remote(T* local, int rank) {
  return cg::this_cluster().map_shared_rank(local, rank);
}

// cnt[key] += (lanes of the warp with pred and this key); all 32 lanes call.
__device__ __forceinline__ void add_by_key(int* cnt, int key, bool pred) {
  const unsigned m = __match_any_sync(kFull, pred ? key : -1);
  if (pred && (threadIdx.x & 31) == __ffs(m) - 1) atomicAdd(&cnt[key], __popc(m));
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The block's sum of v, in every thread.
__device__ int block_sum(int v, Fixed& f) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) f.wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < kWarps; ++w) t += f.wsum[w];
  __syncthreads();
  return t;
}

// The sum of v over the threads before this one; the block's sum in total.
__device__ int block_exclusive_scan(int v, Fixed& f, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) f.wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? f.wsum[lane] : 0;
    int wi = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += t;
    }
    if (lane < kWarps) f.wsum[lane] = wi - w;
    if (lane == kWarps - 1) f.wsum[kWarps] = wi;
  }
  __syncthreads();
  const int out = f.wsum[warp] + incl - v;
  total = f.wsum[kWarps];
  __syncthreads();
  return out;
}

// The largest r >= 0 with (float)r <= slack (0 when none is >= 1): ranks
// 1..R of a stratum's ties are kept. Exact above 2^24 too, where (float)r
// rounds.
__device__ long long last_rank(float slack) {
  if (!(slack >= 1.f)) return 0;
  if (slack >= 2147483648.f) return 1LL << 40;
  long long r = (long long)floorf(slack);
  while ((float)(r + 1) <= slack) ++r;
  return r;
}

// One lane a CTA reads field a (and b) of every CTA's Fixed; the last
// warp (beside the threads of the first strata) leaves the sum of a over
// the CTAs before this one and over all, and the largest b, in f. The
// caller reads them after a block barrier.
__device__ void gather_scalar(Fixed& f, int* a, int* b, int rank, int cs) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kThreads - 32) return;
  const int va = lane < cs ? *remote(a, lane) : 0;
  const int vb = (b != nullptr && lane < cs) ? *remote(b, lane) : -1;
  int before = lane < rank ? va : 0, all = va, mx = vb;
  for (int off = 16; off > 0; off >>= 1) {
    before += __shfl_xor_sync(kFull, before, off);
    all += __shfl_xor_sync(kFull, all, off);
    mx = max(mx, __shfl_xor_sync(kFull, mx, off));
  }
  if (lane == 0) {
    f.sum_before = before;
    f.sum_all = all;
    f.max_all = mx;
  }
}

// Phase 1 over the CTA's slice [begin, end): per-stratum valid counts,
// the valid items and the last valid position, and the histogram of the
// first digit of every eligible item (in hist[1]; after the first cluster
// barrier the caller adds it into every CTA's hist[0] with push_bins).
// Zeroes the state first.
__device__ void count_phase(const int* __restrict__ strata,
                            const uint8_t* __restrict__ valid,
                            const float* __restrict__ prio, int begin,
                            int end, int b, State& st, Fixed& f) {
  const int tid = threadIdx.x, X = st.X;
  for (int i = tid; i < X; i += kThreads) st.cnt[i] = 0;
  for (int i = tid; i < 2 * X * st.B; i += kThreads) st.hist[0][i] = 0;
  if (tid == 0) {
    f.nv = 0;
    f.last = -1;
  }
  __syncthreads();
  const int lo0 = kPrioBits - b;
  int nv = 0, last = -1;
  for (int base = begin; base < end; base += kThreads) {
    const int k = base + tid;
    bool v = false;
    int s = -1, bits = -1;
    if (k < end) {
      v = valid[k] != 0;
      s = strata[k];
      bits = __float_as_int(prio[k]);
    }
    const bool inr = v && s >= 0 && s < X;
    add_by_key(st.cnt, s, inr);
    if (v) {
      ++nv;
      last = k;
    }
    if (inr && bits >= 0) atomicAdd(&st.hist[1][s * st.B + (bits >> lo0)], 1);
  }
  nv = warp_sum(nv);
  for (int off = 16; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, off));
  if ((tid & 31) == 0) {
    atomicAdd(&f.nv, nv);
    atomicMax(&f.last, last);
  }
  __syncthreads();
}

// After the first cluster barrier: the node's valid count per stratum,
// kept as (int)(float)count in st.carry (and as a float in counts, if
// given); the node's valid items, those of earlier CTAs and the last valid
// position.
__device__ void gather_counts(State& st, Fixed& f, int rank, float* counts,
                              int& nv_before, int& nv_total,
                              int& last_valid) {
  for (int s = threadIdx.x; s < st.X; s += kThreads) {
    int total = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < st.cs) total += remote(st.cnt, r)[s];
    const float c = (float)total;
    st.carry[s] = (int)c;
    if (counts != nullptr) counts[s] = c;
  }
  gather_scalar(f, &f.nv, &f.last, rank, st.cs);
  __syncthreads();
  nv_before = f.sum_before;
  nv_total = f.sum_all;
  last_valid = f.max_all;
  __syncthreads();
}

// ---- allocate_reservoirs (repro_torch/core/sampling.py), one thread ------
// The allocation's per-stratum arrays: registers when N > 0 (at most N
// strata; loops run to N, skip i >= X and unroll, so every index is a
// constant), else the scratch (N = 0, any X). The f32 operations and their
// order are the same either way.
constexpr int kRegStrata = 4;
template <int N>
struct Arrays {
  float v[kScratchArrays][N];
  __device__ __forceinline__ float* operator[](int k) { return v[k]; }
};
template <>
struct Arrays<0> {
  float* base;
  int X;
  __device__ __forceinline__ float* operator[](int k) { return base + k * X; }
};

#define FOR_STRATA(i, from)                                           \
  _Pragma("unroll") for (int i = (from); i < (N > 0 ? N : X); ++i) \
    if (N == 0 || i < X)

template <int N>
__device__ __forceinline__ void exclusive_prefix(const float* x, float* out,
                                                 int X) {
  float acc = 0.f;
  FOR_STRATA(i, 0) {
    out[i] = acc;
    acc = acc + x[i];
  }
}

template <int N>
__device__ __forceinline__ float seq_sum(const float* x, int X) {
  float acc = x[0];
  FOR_STRATA(i, 1) acc = acc + x[i];
  return acc;
}

template <int N>
__device__ __forceinline__ void settle(Arrays<N>& a, float budget, int X) {
  float *alloc = a[kAlloc], *counts = a[kCounts], *active = a[kActive];
  float *head = a[kHead], *pre = a[kPre];
  float sum = 0.f;
  FOR_STRATA(i, 0) {
    alloc[i] = active[i] != 0.f ? fminf(alloc[i], counts[i]) : 0.f;
    sum = sum + alloc[i];
  }
  FOR_STRATA(i, 0) head[i] = active[i] != 0.f ? counts[i] - alloc[i] : 0.f;
  const float leftover = budget - sum;
  exclusive_prefix<N>(head, pre, X);
  FOR_STRATA(i, 0)
    alloc[i] = alloc[i] + fminf(fmaxf(leftover - pre[i], 0.f), head[i]);
}

// The allocation of size over the counts (and stds) in a[kCounts]
// (a[kStds]), into a[kAlloc].
template <int N>
__device__ __forceinline__ void allocate(float size, int policy, int X,
                                         Arrays<N>& a) {
  float *alloc = a[kAlloc], *counts = a[kCounts], *stds = a[kStds];
  float* active = a[kActive];  // 1.0 where counts > 0, else 0.0
  float total_c = 0.f, n_active = 0.f;
  FOR_STRATA(i, 0) {
    active[i] = counts[i] > 0.f ? 1.f : 0.f;
    n_active = n_active + (active[i] != 0.f ? 1.f : 0.f);
    total_c = total_c + counts[i];
  }
  n_active = fmaxf(n_active, 1.f);
  const float budget = fminf(size, total_c);

  float* reserve = a[kReserve];
  float* rem_counts = a[kRemCounts];
  float rem_budget = 0.f;
  if (policy != kFair) {
    float *one = a[kOne], *pre = a[kPre];
    float sum_res = 0.f;
    FOR_STRATA(i, 0) one[i] = fminf(counts[i], 1.f);
    exclusive_prefix<N>(one, pre, X);
    FOR_STRATA(i, 0) {
      reserve[i] = fminf(fmaxf(budget - pre[i], 0.f), one[i]);
      sum_res = sum_res + reserve[i];
    }
    rem_budget = budget - sum_res;
    FOR_STRATA(i, 0) rem_counts[i] = counts[i] - reserve[i];
  }

  if (policy == kProportional) {
    float *quota = a[kQuota], *base = a[kBase], *frac = a[kFrac];
    float total = 0.f, sum_base = 0.f;
    FOR_STRATA(i, 0) total = total + rem_counts[i];
    total = fmaxf(total, 1.f);
    FOR_STRATA(i, 0) {
      quota[i] = rem_budget * rem_counts[i] / total;
      base[i] = floorf(quota[i]);
      frac[i] = rem_counts[i] > 0.f ? quota[i] - base[i] : -1.f;
      sum_base = sum_base + base[i];
    }
    const float n_extra = rintf(rem_budget - sum_base);
    FOR_STRATA(i, 0) {
      float rank = 0.f;
      FOR_STRATA(j, 0) {
        const bool ahead = frac[j] > frac[i] || (frac[j] == frac[i] && j < i);
        rank = rank + (ahead ? 1.f : 0.f);
      }
      const float extra = (rem_counts[i] > 0.f && rank < n_extra) ? 1.f : 0.f;
      alloc[i] = reserve[i] + base[i] + extra;
    }
  } else if (policy == kNeyman) {
    float *score = a[kScore], *sv = a[kS];
    FOR_STRATA(i, 0)
      score[i] = active[i] != 0.f ? counts[i] * fmaxf(stds[i], 1e-6f) : 0.f;
    const float s_tot0 = fmaxf(seq_sum<N>(score, X), 1e-30f);
    FOR_STRATA(i, 0)
      alloc[i] = fminf(reserve[i] + floorf(rem_budget * score[i] / s_tot0),
                       counts[i]);
    for (int it = 0; it < 4; ++it) {
      float sum_alloc = 0.f;
      FOR_STRATA(i, 0) {
        sv[i] = (active[i] != 0.f && alloc[i] < counts[i]) ? score[i] : 0.f;
        sum_alloc = sum_alloc + alloc[i];
      }
      const float s_tot = fmaxf(seq_sum<N>(sv, X), 1e-30f);
      const float spare = budget - sum_alloc;
      FOR_STRATA(i, 0)
        alloc[i] = fminf(alloc[i] + floorf(spare * sv[i] / s_tot), counts[i]);
    }
  } else {
    FOR_STRATA(i, 0) alloc[i] = active[i] != 0.f ? floorf(budget / n_active)
                                                 : 0.f;
    float *used = a[kUsed], *capped = a[kCapped];  // capped: 1.0 or 0.0
    for (int it = 0; it < 4; ++it) {
      float surplus = 0.f, n_capped = 0.f;
      FOR_STRATA(i, 0) {
        used[i] = fminf(alloc[i], counts[i]);
        surplus = surplus + (alloc[i] - used[i]);
        capped[i] = (active[i] != 0.f && counts[i] > alloc[i]) ? 1.f : 0.f;
        n_capped = n_capped + capped[i];
      }
      n_capped = fmaxf(n_capped, 1.f);
      FOR_STRATA(i, 0) {
        const float bump = capped[i] != 0.f ? floorf(surplus / n_capped) : 0.f;
        alloc[i] = active[i] != 0.f ? used[i] + bump : 0.f;
      }
    }
  }
  settle<N>(a, budget, X);
}

// Thread 0 of rank 0: the allocation over the node's counts (and stds) in
// the scratch, into scratch[kAlloc * X ...]; returns whether every
// reservoir covers its count.
__device__ bool allocate_node(float size, int policy, int X, float* scratch) {
  if (X <= kRegStrata) {
    Arrays<kRegStrata> a;
    constexpr int N = kRegStrata;
    FOR_STRATA(i, 0) {
      a[kCounts][i] = scratch[kCounts * X + i];
      a[kStds][i] = scratch[kStds * X + i];
    }
    allocate<N>(size, policy, X, a);
    bool sat = true;
    FOR_STRATA(i, 0) {
      scratch[kAlloc * X + i] = a[kAlloc][i];
      sat &= a[kAlloc][i] >= a[kCounts][i];
    }
    return sat;
  }
  Arrays<0> a{scratch, X};
  allocate<0>(size, policy, X, a);
  bool sat = true;
  for (int i = 0; i < X; ++i) sat &= a[kAlloc][i] >= a[kCounts][i];
  return sat;
}

// ---- the neyman moments: staged, sorted by stratum, folded in order ----
constexpr int kFoldGroupsMax = 4; // fold warp pairs at most (32 strata each)
constexpr int kPartWarps = 8;     // partition warps
constexpr int kTileRounds = 8;    // 32-item rounds of a partition warp a tile
constexpr int kSmemTop = 231424;  // dynamic shared memory at most: 227 KB
                                  // less 1 KB for the static
// Named barriers (0 is __syncthreads): the partition warps among
// themselves; sorted tile b filled (kBarFull + b), emptied (kBarEmpty + b);
// the fold warps among themselves.
enum NamedBarrier { kBarPart = 1, kBarFull = 2, kBarEmpty = 4, kBarFold = 6 };

struct StdsPlan {
  int groups, rounds;  // fold warps 2 * groups; tile kPartWarps * rounds
                       // * 32 items
};

__host__ __device__ inline int state_bytes(int X) {
  return (kStateArrays + 2 * (1 << digit_bits(X))) * X * (int)sizeof(int);
}

// Strata a window of the moments' walk: 32 a fold warp pair.
__host__ __device__ inline int stds_window(int X, StdsPlan p) {
  return X < 32 * p.groups ? X : 32 * p.groups;
}

// The phase's shared memory after the state: 16 bytes of alignment, two
// staging slots (values, strata: the tile's 16-byte chunks, T + 8 words;
// valid flags, T + 32 bytes), two sorted tiles (runs padded to 4 items),
// two run tables (start and count a stratum), the partition warps' rows
// of counts, the scan's warp totals, the squares' sums handed over.
__host__ __device__ inline int stds_bytes(int X, StdsPlan p) {
  const int P = kPartWarps, T = 32 * P * p.rounds;
  const int W = stds_window(X, p);
  return 16 + 2 * (8 * (T + 8) + T + 32) + 2 * 4 * (T + 4 * W) +
         4 * (4 * W + P * W + P + W);
}

// The most fold warp pairs (X / 32, at most kFoldGroupsMax), then the
// largest tile, that fit beside the state; one pair and one round fit at
// every X.
__host__ __device__ inline StdsPlan stds_plan(int X) {
  const int most = (X + 31) / 32;
  for (int g = most < kFoldGroupsMax ? most : kFoldGroupsMax; g >= 1; --g)
    for (int r = kTileRounds; r >= 1; --r)
      if (state_bytes(X) + stds_bytes(X, {g, r}) <= kSmemTop) return {g, r};
  return {1, 1};
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
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

// Starts asynchronous copies of the 16-byte chunks that cover bytes
// [src, src + bytes) into dst, chunk i by thread i0 + k * step. A chunk
// that holds a byte of the buffer lies in the buffer's page, so the bytes
// it reads around the buffer exist; the reader skips them.
__device__ __forceinline__ void copy_span(void* dst, const void* src,
                                          int bytes, int i0, int step) {
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)15;
  const int chunks = (int)(((uintptr_t)src + bytes - a + 15) >> 4);
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  for (int i = i0; i < chunks; i += step)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     d + 16 * i),
                 "l"(a + 16 * (uintptr_t)i)
                 : "memory");
}

__device__ __forceinline__ int shift_of(const void* p, int size) {
  return (int)(((uintptr_t)p & 15) / size);
}

// acc + v, or acc + v * v (not contracted: -fmad=false).
template <bool kSquare>
__device__ __forceinline__ float add_term(float acc, float v) {
  return kSquare ? acc + v * v : acc + v;
}

template <bool kSquare>
__device__ __forceinline__ float add_term4(float acc, const float4 v) {
  acc = add_term<kSquare>(acc, v.x);
  acc = add_term<kSquare>(acc, v.y);
  acc = add_term<kSquare>(acc, v.z);
  return add_term<kSquare>(acc, v.w);
}

// acc plus the terms of p[0], ..., p[n - 1], left to right, the next 16
// items' float4 loads issued before the current 16 items' adds; p is
// 16-byte aligned.
template <bool kSquare>
__device__ __forceinline__ float fold_terms(const float* p, int n,
                                            float acc) {
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
      for (int j = 0; j < 4; ++j) acc = add_term4<kSquare>(acc, cur[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = add_term4<kSquare>(acc, cur[j]);
  }
  for (; i < n4; ++i) acc = add_term4<kSquare>(acc, q[i]);
  for (int k = n4 * 4; k < n; ++k) acc = add_term<kSquare>(acc, p[k]);
  return acc;
}

// Per-stratum value standard deviations over the node's valid items
// (neyman only), on one CTA (rank 0's), over the slots [0, m) that hold
// them all: each stratum's values are added in buffer order, the order of
// the plain version's scatter-add, so the result is bitwise the same.
// kPartWarps warps stage and sort, tile by tile (T items: 32 * rounds
// consecutive items a partition warp), window by window (W strata); step
// g of the sequence (window, tile) uses staging slot, sorted tile and run
// table g % 2. The sums of the values and of their squares are two
// independent chains, which a pair of fold warps takes apart, so that
// each issues about half an instruction a cycle and waits on its add
// chain only. Warp w runs on scheduler w % 4: the fold warps are those
// with w % 4 < 2 (pair j: warps 4j, 4j + 1), the partition warps the
// others, so that no partition warp takes a fold warp's issue slots.
// Out of line: inlined, it and the rest of the kernel spilled each
// other's registers and it ran slower. smem: the phase's shared memory
// (stds_bytes), after the state.
__device__ __noinline__ void stds_phase(const float* values,
                                        const int* strata,
                                        const uint8_t* valid, int m, int X,
                                        const float* counts, float* stds,
                                        unsigned char* smem) {
  const StdsPlan plan = stds_plan(X);
  const int F = 2 * plan.groups, P = kPartWarps, R = plan.rounds;
  const int W = stds_window(X, plan), T = 32 * P * R, ST = T + 4 * W;
  const int both = 32 * (F + P);  // the fold and partition warps' threads
  unsigned char* at = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem + 15) & ~(uintptr_t)15);
  float* sv = reinterpret_cast<float*>(at);  // [2][T + 8]
  int* sid = reinterpret_cast<int*>(sv + 2 * (T + 8));  // [2][T + 8]
  uint8_t* sval = reinterpret_cast<uint8_t*>(sid + 2 * (T + 8));
  float* sorted = reinterpret_cast<float*>(sval + 2 * (T + 32));  // [2][ST]
  int* runs = reinterpret_cast<int*>(sorted + 2 * ST);  // [2][start W, n W]
  int* rows = runs + 4 * W;                              // [P][W]
  int* wsum = rows + P * W;                              // [P]
  float* sq = reinterpret_cast<float*>(wsum + P);        // [W]
  const int nt = (m + T - 1) / T;  // tiles of the slots
  const int steps = nt * ((X + W - 1) / W);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if ((warp & 2) == 0) {
    // The fold: lane k of warps 4j and 4j + 1 adds the values and their
    // squares of stratum lo + 32j + k over its run of each sorted tile.
    if ((warp >> 2) >= plan.groups) return;
    const bool square = warp & 1;
    const int k = (warp >> 2) * 32 + lane;
    int g = 0;
    for (int lo = 0; lo < X; lo += W) {
      float acc = 0.f;
      for (int t = 0; t < nt; ++t, ++g) {
        const int b = g & 1;
        named_sync(kBarFull + b, both);
        if (k < W) {
          const float* run = sorted + b * ST + runs[b * 2 * W + k];
          const int n = runs[b * 2 * W + W + k];
          acc = square ? fold_terms<true>(run, n, acc)
                       : fold_terms<false>(run, n, acc);
        }
        if (g + 2 < steps) named_arrive(kBarEmpty + b, both);
      }
      if (square && k < W) sq[k] = acc;
      named_sync(kBarFold, 32 * F);
      const int s = lo + k;
      if (!square && k < W && s < X) {
        const float s1 = acc, s2 = sq[k];
        const float safe = fmaxf(counts[s], 1.f);
        const float mean = s1 / safe;
        // The reference's compiled code contracts this into one FMA.
        const float var = fmaxf(__fmaf_rn(-mean, mean, s2 / safe), 0.f);
        stds[s] = sqrtf(var);
      }
      named_sync(kBarFold, 32 * F);  // sq read before the next window's
    }
    return;
  }

  // The partition: stage, rank, place, scatter.
  const int pw = (warp >> 2) * 2 + (warp & 1), pt = 32 * pw + lane;
  const int np = 32 * P;
  const unsigned below = (1u << lane) - 1u;
  int* mine = rows + pw * W;  // this warp's row
  // Up to 32 strata a window, a key's nb bits group a round's lanes by
  // ballots, and lane k counts stratum k.
  const bool narrow = W <= 32;
  const int nb = 32 - __clz(W - 1);
  auto stage = [&](int g, int slot) {
    if (g < steps) {
      const int base = (g % nt) * T, len = min(T, m - base);
      copy_span(sv + slot * (T + 8), values + base, 4 * len, pt, np);
      copy_span(sid + slot * (T + 8), strata + base, 4 * len, pt, np);
      copy_span(sval + slot * (T + 32), valid + base, len, pt, np);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0, 0);
  stage(1, 1);
  int g = 0;
  for (int lo = 0; lo < X; lo += W) {
    const int hi = min(lo + W, X);
    for (int t = 0; t < nt; ++t, ++g) {
      const int b = g & 1, base = t * T, len = min(T, m - base);
      // This step's copies are in (the next step's may still fly).
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      named_sync(kBarPart, np);
      const float* xv = sv + b * (T + 8) + shift_of(values + base, 4);
      const int* xs = sid + b * (T + 8) + shift_of(strata + base, 4);
      const uint8_t* xk = sval + b * (T + 32) + shift_of(valid + base, 1);
      // 1. Each item's rank among the earlier items of its stratum in its
      // warp's slice, and the warp's count of each stratum in its row.
      float x[kTileRounds];
      int key[kTileRounds], rank[kTileRounds];
#pragma unroll
      for (int r = 0; r < kTileRounds; ++r) {
        const int k = pw * 32 * R + r * 32 + lane;
        const bool in = r < R && k < len && xk[k] != 0;
        const int s = in ? xs[k] : -1;
        key[r] = (in && s >= lo && s < hi) ? s - lo : -1;
        x[r] = in ? xv[k] : 0.f;
      }
      if (narrow) {
        int cnt = 0;  // lane k: the warp's count of stratum k so far
#pragma unroll
        for (int r = 0; r < kTileRounds; ++r) {
          if (r >= R) continue;
          unsigned peers = __ballot_sync(kFull, key[r] >= 0);
          unsigned own = lane < W ? peers : 0u;
          for (int bit = 0; bit < nb; ++bit) {
            const unsigned set = __ballot_sync(kFull, (key[r] >> bit) & 1);
            peers &= (key[r] >> bit) & 1 ? set : ~set;
            own &= (lane >> bit) & 1 ? set : ~set;
          }
          rank[r] = __shfl_sync(kFull, cnt, key[r] & 31) +
                    __popc(peers & below);
          cnt += __popc(own);
        }
        if (lane < W) mine[lane] = cnt;
      } else {
        for (int k = lane; k < W; k += 32) mine[k] = 0;
        __syncwarp();
#pragma unroll
        for (int r = 0; r < kTileRounds; ++r) {
          if (r >= R) continue;
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
      named_sync(kBarPart, np);  // rows counted, slot b read
      stage(g + 2, b);
      // 2. Thread pt < W: its stratum's count n, its run's start (runs one
      // after another, each padded to 4 items), and in row w where warp
      // w's first item of the stratum goes. Sorted tile b and run table b
      // are free once the fold of step g - 2 is done.
      if (g >= 2) named_sync(kBarEmpty + b, both);
      int off[kPartWarps];
      int n = 0, my_start = 0;
      if (pt < W) {
#pragma unroll
        for (int w = 0; w < kPartWarps; ++w) {
          off[w] = n;
          n += rows[w * W + pt];
        }
      }
      const int padded = (n + 3) & ~3;
      if (narrow) {
        if (pw == 0) my_start = warp_scan(padded, lane) - padded;
      } else {
        const int incl = warp_scan(padded, lane);
        if (lane == 31) wsum[pw] = incl;
        named_sync(kBarPart, np);
        if (pw == 0) {
          const int v = lane < P ? wsum[lane] : 0;
          const int e = warp_scan(v, lane) - v;
          if (lane < P) wsum[lane] = e;
        }
        named_sync(kBarPart, np);
        my_start = wsum[pw] + incl - padded;
      }
      if (pt < W) {
#pragma unroll
        for (int w = 0; w < kPartWarps; ++w)
          rows[w * W + pt] = my_start + off[w];
        runs[b * 2 * W + pt] = my_start;
        runs[b * 2 * W + W + pt] = n;
      }
      named_sync(kBarPart, np);
      // 3. The stable sort: each item at its warp's place in its run plus
      // its rank.
      float* out = sorted + b * ST;
#pragma unroll
      for (int r = 0; r < kTileRounds; ++r)
        if (key[r] >= 0) out[mine[key[r]] + rank[r]] = x[r];
      named_arrive(kBarFull + b, both);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Adds this CTA's histogram h (w = 1 << wb bins a stratum, at stride B;
// the strata still searching, or all) into m of every CTA of the cluster,
// and zeroes what it added. The adds are remote atomics whose result no
// one waits for; the next cluster barrier makes them visible.
__device__ void push_bins(State& st, int* h, int* m, int w, int wb,
                          bool all) {
  for (int i = threadIdx.x; i < st.X * w; i += kThreads) {
    const int s = i >> wb, at = s * st.B + (i & (w - 1));
    if (!all && st.kk[s] == 0) continue;
    const int v = h[at];
    if (v == 0) continue;
    h[at] = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < st.cs) atomicAdd(remote(m, r) + at, v);
  }
}

// Picks, for every stratum still searching, the digit of this pass from
// the cluster's histogram h (w bins a stratum, at bit lo): the digit whose
// bin holds the kk-th largest eligible item. On the first pass a stratum
// with fewer than kk eligible items stops with prefix 0. Zeroes the bins
// it read.
__device__ void choose_digits(State& st, int* h, int w, int lo, bool first) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (w >= 32) {  // a warp per stratum, w / 32 bins a lane
    const int q = w >> 5;
    for (int s = warp; s < st.X; s += kWarps) {
      const int k = st.kk[s];
      if (k == 0) continue;
      int* hb = h + s * st.B + lane * q;
      int v[8];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = i < q ? hb[i] : 0;
        sum += v[i];
        if (i < q) hb[i] = 0;
      }
      int incl = sum;  // this lane's bins and those of the lanes above
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_down_sync(kFull, incl, off);
        if (lane + off < 32) incl += t;
      }
      const int above = incl - sum;
      const int total = __shfl_sync(kFull, incl, 0);
      if (first && total < k) {
        if (lane == 0) st.kk[s] = 0;
        continue;
      }
      if (above < k && k <= above + sum) {
        int a = above, d = 0;
#pragma unroll
        for (int i = 7; i > 0; --i) {
          if (i < q && d == 0) {
            if (a + v[i] >= k) d = i;
            else a += v[i];
          }
        }
        st.pre[s] |= (lane * q + d) << lo;
        st.kk[s] = k - a;
      }
    }
  } else {  // a thread per stratum
    for (int s = tid; s < st.X; s += kThreads) {
      const int k = st.kk[s];
      if (k == 0) continue;
      int* hb = h + s * st.B;
      int total = 0;
      for (int d = 0; d < w; ++d) total += hb[d];
      if (first && total < k) {
        st.kk[s] = 0;
      } else {
        int a = 0, d = w - 1;
        for (; d > 0; --d) {
          if (a + hb[d] >= k) break;
          a += hb[d];
        }
        st.pre[s] |= d << lo;
        st.kk[s] = k - a;
      }
      for (int d = 0; d < w; ++d) hb[d] = 0;
    }
  }
}

// One warp ranks a CTA's ties in buffer order (list holds their positions,
// in order): rank = the stratum's ties in earlier CTAs and earlier in the
// list, plus one; kept while (float)rank <= slack.
__device__ void rank_ties(const int* list, int n, const int* strata,
                          State& st, uint8_t* keep) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32) {
    const int e = base + lane;
    const bool in = e < n;
    const int pos = in ? list[e] : 0;
    const int s = in ? strata[pos] : -1;
    const unsigned m = __match_any_sync(kFull, s);
    if (in) {
      const int rank = st.carry[s] + __popc(m & ((2u << lane) - 1u));
      keep[pos] = (float)rank <= __int_as_float(st.kk[s]) ? 1 : 0;
    }
    __syncwarp();
    if (in && lane == 31 - __clz(m)) st.carry[s] += __popc(m);
    __syncwarp();
  }
}

// keep[k] over the CTA's slice, after gather_counts: valid when
// saturated, else tau by radix select and the strict/tie decomposition.
// Returns the keeps of the CTAs before this one and of the node, and
// arrives at the cluster barrier after its last DSMEM read (the caller
// waits on it before it exits). res: the node's reservoirs (global).
__device__ void select_phase(const float* __restrict__ prio,
                             const int* __restrict__ strata,
                             const uint8_t* __restrict__ valid,
                             const float* res, int begin, int end, int rank,
                             int b, bool saturated, int nv_before,
                             int nv_total, State& st, Fixed& f, int* list,
                             uint8_t* keep, int& kept_before,
                             int& kept_total) {
  const int tid = threadIdx.x, X = st.X;
  if (saturated) {
    // N_i >= c_i everywhere: tau sinks below every priority and ties keep
    // all, so the mask is exactly ``valid``.
    cluster_arrive();
    for (int k = begin + tid; k < end; k += kThreads) keep[k] = valid[k] ? 1 : 0;
    kept_before = nv_before;
    kept_total = nv_total;
    __syncthreads();
    return;
  }
  for (int s = tid; s < X; s += kThreads) {
    const int n = (int)res[s], c = st.carry[s];
    st.ties[s] = n;
    st.kk[s] = (n <= 0 || c <= n) ? 0 : n;  // n_eff = n when 1 <= n < c
    st.pre[s] = 0;
  }
  __syncthreads();
  // Pass p chooses the digit at bits [lo, hi) from the cluster's histogram
  // in hist[p % 2]; this CTA builds the next one in hist[p % 2] too, once
  // read, and adds it into every CTA's hist[(p + 1) % 2] (zeroed when its
  // last content was pushed out, before the barrier that precedes these
  // adds). Pass 0's histogram was pushed by the caller.
  const int np = radix_passes(b);
  for (int p = 0; p < np; ++p) {
    const int hi = kPrioBits - p * b, lo = max(0, hi - b), w = 1 << (hi - lo);
    int* merged = st.hist[p & 1];
    if (p > 0) {
      push_bins(st, st.hist[(p & 1) ^ 1], merged, w, hi - lo, false);
      if (p < kProbePasses) PROBE(7 + 3 * p);  // pushed
      cluster_sync();  // every CTA's histogram of this digit is in
    }
    choose_digits(st, merged, w, lo, p == 0);
    __syncthreads();
    if (p < kProbePasses) PROBE(8 + 3 * p);  // chosen
    if (p + 1 == np) break;
    // the next digit's histogram, into merged (its active bins are zero)
    const int hi2 = lo, lo2 = max(0, hi2 - b), mask = (1 << (hi2 - lo2)) - 1;
    for (int k = begin + tid; k < end; k += kThreads) {
      const bool v = valid[k] != 0;
      const int s = strata[k], bits = __float_as_int(prio[k]);
      if (!v || s < 0 || s >= X || bits < 0 || st.kk[s] == 0 ||
          (bits >> hi2) != (st.pre[s] >> hi2))
        continue;
      atomicAdd(&merged[s * st.B + ((bits >> lo2) & mask)], 1);
    }
    __syncthreads();
    if (p < kProbePasses) PROBE(9 + 3 * p);  // next digit's histogram
  }
  for (int s = tid; s < X; s += kThreads) {
    const int n = st.ties[s], c = st.carry[s];
    const float tau = n <= 0 ? 2.0f
                             : (c <= n ? -1.0f
                                       : __int_as_float(min(st.pre[s], kTauMax)));
    st.pre[s] = __float_as_int(tau);
    st.ties[s] = 0;
    st.cnt[s] = 0;
  }
  __syncthreads();
  // Strict keeps and ties, per stratum, over the slice.
  int strict_here = 0;
  for (int base = begin; base < end; base += kThreads) {
    const int k = base + tid;
    bool v = false;
    int s = 0;
    float u = 0.f;
    if (k < end) {
      v = valid[k] != 0;
      s = strata[k];
      u = prio[k];
    }
    const float t = __int_as_float(st.pre[clamp_stratum(s, X)]);
    const bool strict = v && u > t;
    const bool inr = v && s >= 0 && s < X;
    add_by_key(st.cnt, s, inr && strict);
    add_by_key(st.ties, s, inr && !strict && u == t);
    strict_here += strict ? 1 : 0;
  }
  strict_here = block_sum(strict_here, f);
  if (tid == 0) f.strict_total = strict_here;
  PROBE(kProbeSlots - 6);
  cluster_sync();
  PROBE(kProbeSlots - 5);
  // Every CTA's counts: the slack, this CTA's first tie rank, and the
  // keeps before this CTA and in the node.
  long long ties_before = 0, ties_total = 0;
  for (int s = tid; s < X; s += kThreads) {
    int strict = 0, tl[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      tl[r] = 0;
      if (r < st.cs) {
        strict += remote(st.cnt, r)[s];
        tl[r] = remote(st.ties, r)[s];
      }
    }
    const float slack = res[s] - (float)strict;
    const long long last = last_rank(slack);
    long long run = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const long long kept = min(max(last - run, 0LL), (long long)tl[r]);
      if (r < rank) ties_before += kept;
      if (r == rank) st.carry[s] = (int)run;
      ties_total += kept;
      run += tl[r];
    }
    st.kk[s] = __float_as_int(slack);
  }
  gather_scalar(f, &f.strict_total, nullptr, rank, st.cs);
  cluster_arrive();  // no DSMEM read after this
  const int tb = block_sum((int)ties_before, f);
  const int ta = block_sum((int)ties_total, f);
  kept_before = f.sum_before + tb;
  kept_total = f.sum_all + ta;
  PROBE(kProbeSlots - 4);
  // The keeps: strict ones, then ties ranked in buffer order. Each thread
  // takes a run of the slice; ties are marked 2 until ranked.
  const int per = (end - begin + kThreads - 1) / kThreads;
  const int a = min(begin + tid * per, end), z = min(a + per, end);
  int n_ties = 0;
  for (int k = a; k < z; ++k) {
    const bool v = valid[k] != 0;
    const int s = strata[k];
    const float u = prio[k];
    const float t = __int_as_float(st.pre[clamp_stratum(s, X)]);
    const bool strict = v && u > t;
    const bool tie = v && s >= 0 && s < X && !strict && u == t;
    keep[k] = strict ? 1 : (tie ? 2 : 0);
    n_ties += tie ? 1 : 0;
  }
  int total_ties;
  int at = block_exclusive_scan(n_ties, f, total_ties);
  int* ties = list + begin;  // this CTA's share of the node's list
  if (n_ties)
    for (int k = a; k < z; ++k)
      if (keep[k] == 2) ties[at++] = k;
  __syncthreads();
  if (total_ties > 0 && (tid >> 5) == 0)
    rank_ties(ties, total_ties, strata, st, keep);
  __syncthreads();
  PROBE(kProbeSlots - 3);
}

// Writes the kept items of the CTA's slice, in buffer order, to
// [kept_before, ...) of the node's compacted buffers (those below
// out_cap), zeroes the buffers from the node's keep count on (this CTA's
// share), and rank 0 writes the count.
__device__ void compact_phase(const float* values, const int* strata,
                              const uint8_t* keep, int begin, int end,
                              int rank, int cs, int out_cap, int kept_before,
                              int kept_total, Fixed& f, float* vc, int* sc,
                              int* n_keep) {
  const int tid = threadIdx.x;
  const int per = (end - begin + kThreads - 1) / kThreads;
  const int a = min(begin + tid * per, end), z = min(a + per, end);
  int mine = 0;
  for (int k = a; k < z; ++k) mine += keep[k];
  int total;
  int dest = kept_before + block_exclusive_scan(mine, f, total);
  if (mine) {
    for (int k = a; k < z && dest < out_cap; ++k) {
      if (keep[k]) {
        vc[dest] = values[k];
        sc[dest] = strata[k];
        ++dest;
      }
    }
  }
  for (int j = min(kept_total, out_cap) + rank * kThreads + tid; j < out_cap;
       j += cs * kThreads) {
    vc[j] = 0.f;
    sc[j] = 0;
  }
  if (rank == 0 && tid == 0) *n_keep = kept_total;
}

// grid n * cs, clusters of cs CTAs, block kThreads: cluster i owns node i,
// CTA r of it the r-th slice of the node's buffer. kMoments: the neyman
// moments phase (policy == kNeyman); the other policies' instantiation
// has none of its code, so their registers and instructions are those of
// the kernel without it.
template <bool kMoments>
__global__ void __launch_bounds__(kThreads, 1)
fused_level_tick_kernel(const float* __restrict__ values_all,
                        const int* __restrict__ strata_all,
                        const uint8_t* __restrict__ valid_all,
                        const float* __restrict__ prio_all,
                        const float* __restrict__ w_in,
                        const float* __restrict__ c_in,
                        const float* __restrict__ sample_size, int cap, int X,
                        int b, int out_cap, int policy, int async_calibration,
                        float* scratch_all, int* list_all, uint8_t* keep_all,
                        float* values_c, int* strata_c, int* n_keep,
                        float* c_out_counts, float* res_out, float* y_out,
                        float* w_out, float* c_out) {
  __shared__ Fixed f;
  State st = carve(X, b);
  const int rank = (int)cg::this_cluster().block_rank();
  const int node = blockIdx.x / st.cs, tid = threadIdx.x;
  const size_t off = (size_t)node * cap;
  const float* values = values_all + off;
  const int* strata = strata_all + off;
  const uint8_t* valid = valid_all + off;
  const float* prio = prio_all + off;
  uint8_t* keep = keep_all + off;
  const int slice = (cap + st.cs - 1) / st.cs;
  const int begin = min(rank * slice, cap), end = min(begin + slice, cap);
  const int xo = node * X;
  // The allocation's arrays: in shared memory up to kRegStrata strata (its
  // thread keeps them in registers then), else in global memory.
  __shared__ float small_scratch[kScratchArrays * kRegStrata];
  float* scratch = X <= kRegStrata
                       ? small_scratch
                       : scratch_all + (size_t)node * kScratchArrays * X;
  PROBE(0);

  count_phase(strata, valid, prio, begin, end, b, st, f);
  PROBE(1);
  cluster_sync();
  PROBE(2);
  int nv_before, nv_total, last_valid;
  gather_counts(st, f, rank, rank == 0 ? scratch + kCounts * X : nullptr,
                nv_before, nv_total, last_valid);
  push_bins(st, st.hist[1], st.hist[0], st.B, b, true);  // the first digit
  PROBE(3);
  if (rank == 0) {
    // Allocation, then the Alg. 2 lines 12-20 + Eq. 9 weight update.
    const float* counts = scratch + kCounts * X;
    if (kMoments)
      stds_phase(values, strata, valid, last_valid + 1, X, counts,
                 scratch + kStds * X,
                 reinterpret_cast<unsigned char*>(st.carry + X));
    __syncthreads();
    PROBE(kProbeStds);
    if (tid == 0)
      f.saturated = allocate_node(sample_size[0], policy, X, scratch) ? 1 : 0;
    __syncthreads();
    PROBE(4);
    for (int s = tid; s < X; s += kThreads) {
      const float c = counts[s], r = scratch[kAlloc * X + s];
      const float wi = w_in[xo + s], ci = c_in[xo + s];
      const float y = fminf(c, fmaxf(r, 0.f));
      const float w_local = c > r ? c / fmaxf(r, 1.f) : 1.f;
      const float calib = (async_calibration && ci > 0.f && c > 0.f)
                              ? ci / fmaxf(c, 1.f) : 1.f;
      const float w = wi * w_local * calib;
      c_out_counts[xo + s] = c;
      res_out[xo + s] = r;
      y_out[xo + s] = y;
      w_out[xo + s] = c > 0.f ? w : wi;
      c_out[xo + s] = c > 0.f ? y : ci;
    }
  }
  PROBE(5);
  cluster_sync();  // the allocation is out
  PROBE(6);
  const bool saturated = *remote(&f.saturated, 0) != 0;
  int kept_before, kept_total;
  select_phase(prio, strata, valid, res_out + xo, begin, end, rank, b,
               saturated, nv_before, nv_total, st, f,
               list_all + off, keep, kept_before, kept_total);

  float* vc = values_c + (size_t)node * out_cap;
  int* sc = strata_c + (size_t)node * out_cap;
  if (saturated && last_valid + 1 == nv_total) {
    // Everything valid is kept and already at the front: a truncating copy.
    const int nk = min(nv_total, out_cap);
    for (int j = rank * kThreads + tid; j < out_cap; j += st.cs * kThreads) {
      vc[j] = j < nk ? values[j] : 0.f;
      sc[j] = j < nk ? strata[j] : 0;
    }
    if (rank == 0 && tid == 0) n_keep[node] = nv_total;
  } else {
    compact_phase(values, strata, keep, begin, end, rank, st.cs, out_cap,
                  kept_before, kept_total, f, vc, sc, n_keep + node);
  }
  PROBE(kProbeSlots - 2);
  cluster_wait();  // no CTA leaves while another may read its shared memory
  PROBE(kProbeSlots - 1);
}

// grid cs (one cluster), block kThreads.
__global__ void __launch_bounds__(kThreads, 1)
fused_select_kernel(const float* __restrict__ prio,
                    const int* __restrict__ strata,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ reservoirs, int m, int X, int b,
                    int* list, uint8_t* keep) {
  __shared__ Fixed f;
  State st = carve(X, b);
  const int rank = (int)cg::this_cluster().block_rank();
  const int slice = (m + st.cs - 1) / st.cs;
  const int begin = min(rank * slice, m), end = min(begin + slice, m);
  PROBE(0);
  count_phase(strata, valid, prio, begin, end, b, st, f);
  PROBE(1);
  cluster_sync();
  PROBE(2);
  int nv_before, nv_total, last_valid;
  gather_counts(st, f, rank, nullptr, nv_before, nv_total, last_valid);
  PROBE(3);
  int sat = 1;
  for (int s = threadIdx.x; s < X; s += kThreads)
    sat &= reservoirs[s] >= (float)st.carry[s];
  const bool saturated = __syncthreads_and(sat) != 0;
  if (!saturated) {
    push_bins(st, st.hist[1], st.hist[0], st.B, b, true);  // the first digit
    cluster_sync();
  }
  PROBE(6);
  int kept_before, kept_total;
  select_phase(prio, strata, valid, reservoirs, begin, end, rank, b,
               saturated, nv_before, nv_total, st, f, list, keep,
               kept_before, kept_total);
  PROBE(kProbeSlots - 2);
  cluster_wait();
  PROBE(kProbeSlots - 1);
}

// smem: the state's dynamic shared memory, and the neyman moments' with
// extra.
cudaError_t launch_cluster_setup(const void* kernel, int X, bool extra,
                                 size_t& smem) {
  smem = (size_t)state_bytes(X);
  if (extra) smem += (size_t)stds_bytes(X, stds_plan(X));
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

cudaLaunchConfig_t cluster_config(int clusters, int cs, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of global scratch per node that fused_level_tick_launch needs
// (beside an int per slot for the tie lists).
int fused_level_tick_scratch_words(int X) { return kScratchArrays * X; }

// Bits per radix digit at X strata.
int fused_level_tick_digit_bits(int X) { return digit_bits(X); }

// Passes of tau's radix select over a node's slots at X strata.
int fused_level_tick_radix_passes(int X) {
  return radix_passes(digit_bits(X));
}

// Walks of the neyman moments over a node's valid prefix at X strata, one
// a window of strata (0 for the other policies, which have no moments).
int fused_level_tick_moment_windows(int X, int policy) {
  if (policy != kNeyman) return 0;
  const int W = stds_window(X, stds_plan(X));
  return (X + W - 1) / W;
}

#ifdef REPRO_PHASE_PROBE
// Names the buffer of kProbeSlots timestamps a CTA (nullptr: none).
int fused_level_tick_set_probe(long long* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, &buf, sizeof(buf)));
}

int fused_level_tick_probe_slots() { return kProbeSlots; }
#endif

int fused_level_tick_launch(const float* values, const int* strata,
                            const uint8_t* valid, const float* prio,
                            const float* w_in, const float* c_in,
                            const float* sample_size, int n, int cap, int X,
                            int out_cap, int policy, int async_calibration,
                            int cs, float* scratch, int* list, uint8_t* keep,
                            float* values_c, int* strata_c, int* n_keep,
                            float* c, float* reservoirs, float* y,
                            float* w_out, float* c_out, cudaStream_t stream) {
  if (X < 1 || X > kMaxStrata || cs < 1 || cs > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool moments = policy == kNeyman;
  auto* kernel = moments ? fused_level_tick_kernel<true>
                         : fused_level_tick_kernel<false>;
  size_t smem;
  cudaError_t err = launch_cluster_setup(
      reinterpret_cast<const void*>(kernel), X, moments, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(n, cs, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, values, strata,
                           valid, prio, w_in, c_in, sample_size, cap, X,
                           digit_bits(X), out_cap, policy, async_calibration,
                           scratch, list, keep, values_c, strata_c, n_keep,
                           c, reservoirs, y, w_out, c_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int fused_select_launch(const float* prio, const int* strata,
                        const uint8_t* valid, const float* reservoirs, int m,
                        int X, int cs, int* list, uint8_t* keep,
                        cudaStream_t stream) {
  if (X < 1 || X > kMaxStrata || cs < 1 || cs > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem;
  cudaError_t err = launch_cluster_setup(
      reinterpret_cast<const void*>(fused_select_kernel), X, false, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, cs, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, fused_select_kernel, prio, strata, valid,
                           reservoirs, m, X, digit_bits(X), list, keep);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
