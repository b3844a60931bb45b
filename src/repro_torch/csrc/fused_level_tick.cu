// The whole WHS tick of one hierarchy level, and selection alone, on Hopper.
//
// Replaces repro/kernels/fused_level_tick/fused_level_tick.py:
//   fused_level_tick (body _kernel)        -> fused_level_tick_kernel
//   fused_select     (body _select_kernel) -> fused_select_kernel
//
// What bounds it on this card: not bytes. One node's buffer (cap items of
// 13 bytes) is read some 35 times from L1/L2, once per pass: the counts,
// 31 bisection rounds for the thresholds, the strict count, the tie ranks
// and the compaction. Each pass ends in a block barrier, and the grid has
// one block per node (4 blocks at level 0 of the paper's testbed), so the
// kernel is bound by the latency of those dependent passes on a few SMs,
// not by device memory or arithmetic.
//
// What the design does about it: one 1024-thread block per node walks the
// buffer with a stride, so each pass is short; per-stratum counts are warp
// ballots and integer shared-memory atomics (exact and deterministic); the
// TPU kernel's one-hot matmuls become plain indexed loads and stores. The
// allocation and the Eq. 9 weight update run on one thread with the same
// f32 operations in the same order as repro_torch/core/sampling.py and
// repro_torch/core/whs.py; the file is built with -fmad=false so that no
// multiply-add is contracted. Spreading a node over several blocks, and
// keeping the buffer in shared memory, are left for a later change.
//
// Tie law: items with u > tau are kept; items with u == tau (exact f32
// ties) are kept in buffer order while their rank within the stratum is at
// most N - (strict keeps). This is the stable lexsort's law, so masks equal
// the argsort reference bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStrata = 32;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSearchIters = 31;
constexpr unsigned kFull = 0xffffffffu;

enum Policy { kFair = 0, kProportional = 1, kNeyman = 2 };

struct Shared {
  int cnt[kMaxStrata];     // scratch per-stratum counter
  int lo[kMaxStrata], hi[kMaxStrata], mid[kMaxStrata], n_eff[kMaxStrata];
  int n_int[kMaxStrata], c_int[kMaxStrata];
  float c[kMaxStrata], res[kMaxStrata], tau[kMaxStrata], slack[kMaxStrata];
  float stds[kMaxStrata];
  int wtot[kWarps];
  int n_valid, last_valid, saturated;
};

__device__ __forceinline__ int clamp_stratum(int s, int X) {
  return s < 0 ? 0 : (s >= X ? X - 1 : s);
}

// Adds to cnt[s], for every stratum s < X, the number of items k < m with
// pred(k) and strata[k] == s: one ballot per stratum per 32 items, one
// shared-memory atomic per warp per stratum.
template <class Pred>
__device__ void count_by_stratum(const int* strata, int m, int X, Pred pred,
                                 int* cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int acc = 0;
  for (int base = warp * 32; base < m; base += kThreads) {
    const int k = base + lane;
    bool p = false;
    int s = -1;
    if (k < m) {
      p = pred(k);
      s = strata[k];
    }
    for (int x = 0; x < X; ++x) {
      const unsigned b = __ballot_sync(kFull, p && s == x);
      if (lane == x) acc += __popc(b);
    }
  }
  if (lane < X && acc != 0) atomicAdd(&cnt[lane], acc);
}

// Counts c, the number of valid items and the last valid position.
__device__ void count_phase(const int* strata, const uint8_t* valid, int m,
                            int X, Shared& sm) {
  const int tid = threadIdx.x;
  if (tid < kMaxStrata) sm.cnt[tid] = 0;
  if (tid == 0) {
    sm.n_valid = 0;
    sm.last_valid = -1;
  }
  __syncthreads();
  count_by_stratum(strata, m, X, [&](int k) { return valid[k] != 0; }, sm.cnt);
  int nv = 0, last = -1;
  for (int k = tid; k < m; k += kThreads) {
    if (valid[k]) {
      ++nv;
      last = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    nv += __shfl_down_sync(kFull, nv, off);
    last = max(last, __shfl_down_sync(kFull, last, off));
  }
  if ((tid & 31) == 0) {
    atomicAdd(&sm.n_valid, nv);
    atomicMax(&sm.last_valid, last);
  }
  __syncthreads();
  if (tid < X) sm.c[tid] = (float)sm.cnt[tid];
  __syncthreads();
}

// ---- allocate_reservoirs (repro_torch/core/sampling.py), one thread ------
__device__ void exclusive_prefix(const float* x, float* out, int X) {
  float acc = 0.f;
  for (int i = 0; i < X; ++i) {
    out[i] = acc;
    acc = acc + x[i];
  }
}

__device__ float seq_sum(const float* x, int X) {
  float acc = x[0];
  for (int i = 1; i < X; ++i) acc = acc + x[i];
  return acc;
}

__device__ void settle(float* alloc, const float* counts, const bool* active,
                       float budget, int X) {
  float head[kMaxStrata], pre[kMaxStrata];
  float sum = 0.f;
  for (int i = 0; i < X; ++i) {
    alloc[i] = active[i] ? fminf(alloc[i], counts[i]) : 0.f;
    sum = sum + alloc[i];
  }
  for (int i = 0; i < X; ++i) head[i] = active[i] ? counts[i] - alloc[i] : 0.f;
  const float leftover = budget - sum;
  exclusive_prefix(head, pre, X);
  for (int i = 0; i < X; ++i)
    alloc[i] = alloc[i] + fminf(fmaxf(leftover - pre[i], 0.f), head[i]);
}

__device__ void allocate(float size, const float* counts, const float* stds,
                         int policy, int X, float* alloc) {
  bool active[kMaxStrata];
  float total_c = 0.f, n_active = 0.f;
  for (int i = 0; i < X; ++i) {
    active[i] = counts[i] > 0.f;
    n_active = n_active + (active[i] ? 1.f : 0.f);
    total_c = total_c + counts[i];
  }
  n_active = fmaxf(n_active, 1.f);
  const float budget = fminf(size, total_c);

  float reserve[kMaxStrata], rem_counts[kMaxStrata], rem_budget = 0.f;
  if (policy != kFair) {
    float one[kMaxStrata], pre[kMaxStrata], sum_res = 0.f;
    for (int i = 0; i < X; ++i) one[i] = fminf(counts[i], 1.f);
    exclusive_prefix(one, pre, X);
    for (int i = 0; i < X; ++i) {
      reserve[i] = fminf(fmaxf(budget - pre[i], 0.f), one[i]);
      sum_res = sum_res + reserve[i];
    }
    rem_budget = budget - sum_res;
    for (int i = 0; i < X; ++i) rem_counts[i] = counts[i] - reserve[i];
  }

  if (policy == kProportional) {
    float quota[kMaxStrata], base[kMaxStrata], frac[kMaxStrata];
    float total = 0.f, sum_base = 0.f;
    for (int i = 0; i < X; ++i) total = total + rem_counts[i];
    total = fmaxf(total, 1.f);
    for (int i = 0; i < X; ++i) {
      quota[i] = rem_budget * rem_counts[i] / total;
      base[i] = floorf(quota[i]);
      frac[i] = rem_counts[i] > 0.f ? quota[i] - base[i] : -1.f;
      sum_base = sum_base + base[i];
    }
    const float n_extra = rintf(rem_budget - sum_base);
    for (int i = 0; i < X; ++i) {
      float rank = 0.f;
      for (int j = 0; j < X; ++j) {
        const bool ahead = frac[j] > frac[i] || (frac[j] == frac[i] && j < i);
        rank = rank + (ahead ? 1.f : 0.f);
      }
      const float extra = (rem_counts[i] > 0.f && rank < n_extra) ? 1.f : 0.f;
      alloc[i] = reserve[i] + base[i] + extra;
    }
  } else if (policy == kNeyman) {
    float score[kMaxStrata], s[kMaxStrata];
    for (int i = 0; i < X; ++i)
      score[i] = active[i] ? counts[i] * fmaxf(stds[i], 1e-6f) : 0.f;
    const float s_tot0 = fmaxf(seq_sum(score, X), 1e-30f);
    for (int i = 0; i < X; ++i)
      alloc[i] = fminf(reserve[i] + floorf(rem_budget * score[i] / s_tot0),
                       counts[i]);
    for (int it = 0; it < 4; ++it) {
      float sum_alloc = 0.f;
      for (int i = 0; i < X; ++i) {
        s[i] = (active[i] && alloc[i] < counts[i]) ? score[i] : 0.f;
        sum_alloc = sum_alloc + alloc[i];
      }
      const float s_tot = fmaxf(seq_sum(s, X), 1e-30f);
      const float spare = budget - sum_alloc;
      for (int i = 0; i < X; ++i)
        alloc[i] = fminf(alloc[i] + floorf(spare * s[i] / s_tot), counts[i]);
    }
  } else {
    for (int i = 0; i < X; ++i)
      alloc[i] = active[i] ? floorf(budget / n_active) : 0.f;
    for (int it = 0; it < 4; ++it) {
      float used[kMaxStrata];
      bool capped[kMaxStrata];
      float surplus = 0.f, n_capped = 0.f;
      for (int i = 0; i < X; ++i) {
        used[i] = fminf(alloc[i], counts[i]);
        surplus = surplus + (alloc[i] - used[i]);
        capped[i] = active[i] && counts[i] > alloc[i];
        n_capped = n_capped + (capped[i] ? 1.f : 0.f);
      }
      n_capped = fmaxf(n_capped, 1.f);
      for (int i = 0; i < X; ++i) {
        const float bump = capped[i] ? floorf(surplus / n_capped) : 0.f;
        alloc[i] = active[i] ? used[i] + bump : 0.f;
      }
    }
  }
  settle(alloc, counts, active, budget, X);
}

// Per-stratum value standard deviations over valid items (neyman only):
// one thread per stratum adds the values in buffer order, the order of
// the plain version's scatter-add, so the result is bitwise the same.
__device__ void stds_phase(const float* values, const int* strata,
                           const uint8_t* valid, int m, int X, Shared& sm) {
  const int s = threadIdx.x;
  if (s < X) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < m; ++k) {
      if (valid[k] && strata[k] == s) {
        const float v = values[k];
        s1 = s1 + v;
        s2 = s2 + v * v;
      }
    }
    const float safe = fmaxf(sm.c[s], 1.f);
    const float mean = s1 / safe;
    // The reference's compiled code contracts this into one FMA.
    const float var = fmaxf(__fmaf_rn(-mean, mean, s2 / safe), 0.f);
    sm.stds[s] = sqrtf(var);
  }
  __syncthreads();
}

// keep[k] for the whole buffer: valid when saturated, else the tau search
// and the strict/tie decomposition. Expects sm.c, sm.res and sm.saturated.
__device__ void select_phase(const float* prio, const int* strata,
                             const uint8_t* valid, int m, int X, Shared& sm,
                             uint8_t* keep) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (sm.saturated) {
    // N_i >= c_i everywhere: tau sinks below every priority and ties keep
    // all, so the mask is exactly ``valid``.
    for (int k = tid; k < m; k += kThreads) keep[k] = valid[k] ? 1 : 0;
    __syncthreads();
    return;
  }
  if (tid < X) {
    const int n = (int)sm.res[tid], c = (int)sm.c[tid];
    sm.n_int[tid] = n;
    sm.c_int[tid] = c;
    sm.n_eff[tid] = max(min(n, c), 1);
    sm.lo[tid] = 0;               // F(0) = c >= n_eff
    sm.hi[tid] = 0x3F800001;      // above the bits of every u < 1
  }
  const int* u_bits = reinterpret_cast<const int*>(prio);
  for (int it = 0; it < kSearchIters; ++it) {
    if (tid < X) {
      sm.mid[tid] = (sm.lo[tid] + sm.hi[tid]) / 2;
      sm.cnt[tid] = 0;
    }
    __syncthreads();
    count_by_stratum(
        strata, m, X,
        [&](int k) {
          return valid[k] && u_bits[k] >= sm.mid[clamp_stratum(strata[k], X)];
        },
        sm.cnt);
    __syncthreads();
    if (tid < X) {
      if (sm.cnt[tid] >= sm.n_eff[tid]) sm.lo[tid] = sm.mid[tid];
      else sm.hi[tid] = sm.mid[tid];
    }
  }
  if (tid < X) {
    const int n = sm.n_int[tid];
    sm.tau[tid] = n <= 0 ? 2.0f
                         : (sm.c_int[tid] <= n ? -1.0f : __int_as_float(sm.lo[tid]));
    sm.cnt[tid] = 0;
  }
  __syncthreads();
  auto strict = [&](int k) {
    return valid[k] && prio[k] > sm.tau[clamp_stratum(strata[k], X)];
  };
  count_by_stratum(strata, m, X, strict, sm.cnt);
  for (int k = tid; k < m; k += kThreads) keep[k] = strict(k) ? 1 : 0;
  __syncthreads();
  if (tid < X) sm.slack[tid] = sm.res[tid] - (float)sm.cnt[tid];
  __syncthreads();
  // Ties at tau, ranked by buffer position: one warp per stratum walks the
  // buffer in order.
  for (int s = warp; s < X; s += kWarps) {
    const float t = sm.tau[s], slack = sm.slack[s];
    int carry = 0;
    for (int base = 0; base < m; base += 32) {
      const int k = base + lane;
      const bool tie = k < m && valid[k] && strata[k] == s && prio[k] == t;
      const unsigned b = __ballot_sync(kFull, tie);
      const int rank = carry + __popc(b & ((2u << lane) - 1u));  // inclusive
      if (tie && (float)rank <= slack) keep[k] = 1;
      carry += __popc(b);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fused_level_tick_kernel(const float* __restrict__ values_all,
                        const int* __restrict__ strata_all,
                        const uint8_t* __restrict__ valid_all,
                        const float* __restrict__ prio_all,
                        const float* __restrict__ w_in,
                        const float* __restrict__ c_in,
                        const float* __restrict__ sample_size, int cap, int X,
                        int out_cap, int policy, int async_calibration,
                        uint8_t* keep_all, float* values_c, int* strata_c,
                        int* n_keep, float* c_out_counts, float* res_out,
                        float* y_out, float* w_out, float* c_out) {
  __shared__ Shared sm;
  const int node = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const size_t off = (size_t)node * cap;
  const float* values = values_all + off;
  const int* strata = strata_all + off;
  const uint8_t* valid = valid_all + off;
  const float* prio = prio_all + off;
  uint8_t* keep = keep_all + off;
  float* vc = values_c + (size_t)node * out_cap;
  int* sc = strata_c + (size_t)node * out_cap;
  const int xo = node * X;

  count_phase(strata, valid, cap, X, sm);
  if (policy == kNeyman) stds_phase(values, strata, valid, cap, X, sm);

  // Allocation, then the Alg. 2 lines 12-20 + Eq. 9 weight update.
  if (tid == 0) {
    float alloc[kMaxStrata];
    allocate(sample_size[0], sm.c, sm.stds, policy, X, alloc);
    int sat = 1;
    for (int i = 0; i < X; ++i) {
      sm.res[i] = alloc[i];
      sat &= alloc[i] >= sm.c[i];
    }
    sm.saturated = sat;
  }
  __syncthreads();
  if (tid < X) {
    const float c = sm.c[tid], r = sm.res[tid];
    const float wi = w_in[xo + tid], ci = c_in[xo + tid];
    const float y = fminf(c, fmaxf(r, 0.f));
    const float w_local = c > r ? c / fmaxf(r, 1.f) : 1.f;
    const float calib = (async_calibration && ci > 0.f && c > 0.f)
                            ? ci / fmaxf(c, 1.f) : 1.f;
    const float w = wi * w_local * calib;
    c_out_counts[xo + tid] = c;
    res_out[xo + tid] = r;
    y_out[xo + tid] = y;
    w_out[xo + tid] = c > 0.f ? w : wi;
    c_out[xo + tid] = c > 0.f ? y : ci;
  }

  select_phase(prio, strata, valid, cap, X, sm, keep);

  // Compaction.
  const int n_valid = sm.n_valid;
  const bool front_packed = sm.last_valid + 1 == n_valid;
  if (sm.saturated && front_packed) {
    // Everything valid is kept and already at the front: a truncating copy.
    const int nk = min(n_valid, out_cap);
    for (int j = tid; j < out_cap; j += kThreads) {
      vc[j] = j < nk ? values[j] : 0.f;
      sc[j] = j < nk ? strata[j] : 0;
    }
    if (tid == 0) n_keep[node] = n_valid;
    return;
  }
  int carry = 0;
  for (int base = 0; base < cap; base += kThreads) {
    const int k = base + tid;
    const bool f = k < cap && keep[k];
    const unsigned b = __ballot_sync(kFull, f);
    if (lane == 0) sm.wtot[warp] = __popc(b);
    __syncthreads();
    int woff = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = sm.wtot[w];
      woff += w < warp ? t : 0;
      total += t;
    }
    const int dest = carry + woff + __popc(b & ((1u << lane) - 1u));
    if (f && dest < out_cap) {
      vc[dest] = values[k];
      sc[dest] = strata[k];
    }
    carry += total;
    __syncthreads();
  }
  for (int j = min(carry, out_cap) + tid; j < out_cap; j += kThreads) {
    vc[j] = 0.f;
    sc[j] = 0;
  }
  if (tid == 0) n_keep[node] = carry;
}

__global__ void __launch_bounds__(kThreads)
fused_select_kernel(const float* __restrict__ prio,
                    const int* __restrict__ strata,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ reservoirs, int m, int X,
                    uint8_t* keep) {
  __shared__ Shared sm;
  const int tid = threadIdx.x;
  count_phase(strata, valid, m, X, sm);
  if (tid == 0) {
    int sat = 1;
    for (int i = 0; i < X; ++i) {
      sm.res[i] = reservoirs[i];
      sat &= reservoirs[i] >= sm.c[i];
    }
    sm.saturated = sat;
  }
  __syncthreads();
  select_phase(prio, strata, valid, m, X, sm, keep);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fused_level_tick_launch(const float* values, const int* strata,
                            const uint8_t* valid, const float* prio,
                            const float* w_in, const float* c_in,
                            const float* sample_size, int n, int cap, int X,
                            int out_cap, int policy, int async_calibration,
                            uint8_t* keep, float* values_c, int* strata_c,
                            int* n_keep, float* c, float* reservoirs, float* y,
                            float* w_out, float* c_out, cudaStream_t stream) {
  fused_level_tick_kernel<<<n, kThreads, 0, stream>>>(
      values, strata, valid, prio, w_in, c_in, sample_size, cap, X, out_cap,
      policy, async_calibration, keep, values_c, strata_c, n_keep, c,
      reservoirs, y, w_out, c_out);
  return static_cast<int>(cudaGetLastError());
}

int fused_select_launch(const float* prio, const int* strata,
                        const uint8_t* valid, const float* reservoirs, int m,
                        int X, uint8_t* keep, cudaStream_t stream) {
  fused_select_kernel<<<1, kThreads, 0, stream>>>(prio, strata, valid,
                                                  reservoirs, m, X, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
