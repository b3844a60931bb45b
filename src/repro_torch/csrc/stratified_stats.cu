// Per-stratum (count, sum x, sum x^2) over masked items, on Hopper.
//
// Replaces repro/kernels/stratified_stats/stratified_stats.py:
//   stratified_stats (body _kernel) -> stratified_stats_rows (X <= 24),
//   stratified_stats_warp_rows (X > 24)
//
// What bounds it on this card: device memory in principle (9 bytes read
// per item, 12 bytes written per stratum), but at the path's sizes (2,200
// to 44,032 items) one launch's fixed cost and the chain of dependent
// steps inside it.
//
// What the design does about it: the TPU kernel walks item tiles in order
// and accumulates one-hot matmuls into one output block. Here one launch
// does it all, with no scratch in device memory. No float is added with
// an atomic, so Σx and Σx² come out in a fixed order that depends only on
// (M, X), not on timing; counts are integers, so exact. Each item costs
// the same whatever X is, in one of two layouts:
// - up to 24 strata (every path shape): one thread-block cluster of up to
//   8 CTAs of 512 threads (one CTA for every 4,096 items), CTA r taking
//   the r-th slice of the items. Each thread adds its items into its own
//   row of shared memory (an entry per thread and stratum, stratum-major,
//   (Σx, Σx², count) in 16 bytes: one load and one store an item), 8
//   items' loads in flight at once; one warp a stratum adds the threads'
//   rows, each lane a strided share in thread order and then a fixed
//   butterfly over the lanes, and stores the CTA's partials into CTA 0's
//   shared memory (distributed shared memory). After one cluster barrier
//   CTA 0 adds the CTAs' partials in rank order and writes the output;
//   the others have already left;
// - above 24 strata: one CTA, a row per warp and stratum. Per 32-item
//   round the warp groups its lanes by stratum (__match_any_sync) and each
//   group's lowest lane adds its peers' values in lane order (from a
//   staging row) into the warp's row; one thread a stratum adds the warps'
//   rows in warp order and writes the output. Fewer warps where X rows of
//   every warp do not fit (4 at 4,096 strata).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;
constexpr int kItemsPerCta = 4096;
constexpr int kThreadRowStrata = 24;   // per-thread rows up to this X
constexpr int kRowThreads = 512;       // threads of a per-thread-row CTA
constexpr int kMaxThreads = 1024;
constexpr int kRowBytes = 196608;      // shared memory for per-warp rows
constexpr int kUnroll = 8;             // items (or rounds) loaded at once
constexpr unsigned kFull = 0xffffffffu;

// Phase timestamps for tools/sum_phases.py: built with
// -DREPRO_PHASE_PROBE, thread 0 of each CTA writes %globaltimer (ns, the
// same clock on every SM) and clock64 (its SM's cycles) at the end of
// each phase to the buffer that stratified_stats_set_probe names, after a
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

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Threads a CTA, CTAs in the cluster, and dynamic shared memory (bytes):
// per-thread rows take 16·X bytes a thread, plus CTA 0's partials of
// every CTA; per-warp rows 12·X bytes a warp.
struct Config {
  int threads, cs;
  size_t smem;
};

Config config(int m, int X) {
  if (X <= kThreadRowStrata) {
    int cs = (m + kItemsPerCta - 1) / kItemsPerCta;
    cs = cs < 1 ? 1 : (cs > kMaxCluster ? kMaxCluster : cs);
    return {kRowThreads, cs,
            (size_t)16 * X * (kRowThreads + kMaxCluster)};
  }
  int w = kRowBytes / (12 * X);
  w = w < 1 ? 1 : (w > kMaxThreads / 32 ? kMaxThreads / 32 : w);
  return {32 * w, 1, (size_t)12 * X * w};
}

constexpr size_t kMaxSmem =
    (size_t)16 * kThreadRowStrata * (kRowThreads + kMaxCluster);

// Up to 24 strata. grid cs (one cluster), block kRowThreads, dynamic
// shared memory config().smem. CTA r takes items [r·per, (r+1)·per).
__global__ void __launch_bounds__(kRowThreads)
stratified_stats_rows(const float* __restrict__ values,
                      const int* __restrict__ strata,
                      const uint8_t* __restrict__ mask, int m, int X,
                      int per, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T = kRowThreads, W = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int lo = min(rank * per, m), hi = min(lo + per, m);
  // A row entry is (Σx, Σx², count as int bits, unused): one 16-byte
  // load and store an item.
  float4* rows = reinterpret_cast<float4*>(smem);   // [X][T]
  float4* recv = rows + X * T;                      // [cs][X], CTA 0's
  PROBE(0);
  for (int k = tid; k < X * T; k += T)
    rows[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  PROBE(1);
  for (int i0 = lo + tid; i0 < hi; i0 += kUnroll * T) {
    float x[kUnroll];
    int s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * T;
      const bool in = i < hi;       // the three loads issued together
      const bool ok = in && mask[i];
      const int st = in ? strata[i] : -1;
      x[u] = in ? values[i] : 0.f;
      s[u] = ok ? st : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s[u] >= 0 && s[u] < X) {
        float4 e = rows[s[u] * T + tid];
        e.x = e.x + x[u];
        e.y = e.y + x[u] * x[u];
        e.z = __int_as_float(__float_as_int(e.z) + 1);
        rows[s[u] * T + tid] = e;
      }
    }
  }
  __syncthreads();
  PROBE(2);
  for (int s = warp; s < X; s += W) {
    float a = 0.f, b = 0.f;
    int c = 0;
#pragma unroll
    for (int k = lane; k < T; k += 32) {
      const float4 e = rows[s * T + k];
      a = a + e.x;
      b = b + e.y;
      c += __float_as_int(e.z);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a = a + __shfl_xor_sync(kFull, a, off);
      b = b + __shfl_xor_sync(kFull, b, off);
      c += __shfl_xor_sync(kFull, c, off);
    }
    if (lane == 0)
      cluster.map_shared_rank(recv, 0)[rank * X + s] =
          make_float4(a, b, __int_as_float(c), 0.f);
  }
  PROBE(3);
  if (cs > 1) cluster_sync();  // every CTA's partials are in CTA 0
  else __syncthreads();
  PROBE(4);
  if (rank == 0) {
    for (int s = tid; s < X; s += T) {
      float a = 0.f, b = 0.f;
      int c = 0;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < cs) {
          const float4 e = recv[r * X + s];
          a = a + e.x;
          b = b + e.y;
          c += __float_as_int(e.z);
        }
      }
      out[3 * s] = (float)c;
      out[3 * s + 1] = a;
      out[3 * s + 2] = b;
    }
  }
  PROBE(5);
}

// Above 24 strata. grid 1, block config().threads, dynamic shared memory
// config().smem.
__global__ void __launch_bounds__(kMaxThreads)
stratified_stats_warp_rows(const float* __restrict__ values,
                           const int* __restrict__ strata,
                           const uint8_t* __restrict__ mask, int m, int X,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float stage[kMaxThreads / 32][32];
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, W = T >> 5;
  const unsigned below = (1u << lane) - 1u;
  float* r1 = reinterpret_cast<float*>(smem);   // [W][X]
  float* r2 = r1 + W * X;
  int* rc = reinterpret_cast<int*>(r2 + W * X);
  PROBE(0);
  for (int k = tid; k < W * X; k += T) {
    r1[k] = 0.f;
    r2[k] = 0.f;
    rc[k] = 0;
  }
  __syncthreads();
  PROBE(1);
  float* w1 = r1 + warp * X;
  float* w2 = r2 + warp * X;
  int* wc = rc + warp * X;
  for (int i0 = warp * 32 + lane; i0 - lane < m; i0 += kUnroll * T) {
    float x[kUnroll];
    int s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * T;
      const bool in = i < m;
      const bool ok = in && mask[i];
      const int st = in ? strata[i] : -1;
      x[u] = in ? values[i] : 0.f;
      s[u] = ok && st >= 0 && st < X ? st : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned peers = __match_any_sync(kFull, s[u]);
      stage[warp][lane] = x[u];
      __syncwarp();
      if (s[u] >= 0 && (peers & below) == 0) {
        float a = 0.f, b = 0.f;
        for (unsigned p = peers; p; p &= p - 1) {
          const float y = stage[warp][__ffs(p) - 1];
          a = a + y;
          b = b + y * y;
        }
        w1[s[u]] = w1[s[u]] + a;
        w2[s[u]] = w2[s[u]] + b;
        wc[s[u]] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  PROBE(2);
  for (int s = tid; s < X; s += T) {
    float a = 0.f, b = 0.f;
    int c = 0;
    for (int w = 0; w < W; ++w) {
      a = a + r1[w * X + s];
      b = b + r2[w * X + s];
      c += rc[w * X + s];
    }
    out[3 * s] = (float)c;
    out[3 * s + 1] = a;
    out[3 * s + 2] = b;
  }
  PROBE(5);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef REPRO_PHASE_PROBE
int stratified_stats_set_probe(long long* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, &buf, sizeof(buf)));
}

int stratified_stats_probe_slots() { return kProbeSlots; }
#endif

int stratified_stats_launch(const float* values, const int* strata,
                            const uint8_t* mask, int m, int X, float* out,
                            cudaStream_t stream) {
  static bool ready = false;
  cudaError_t err;
  if (!ready) {
    err = cudaFuncSetAttribute(stratified_stats_rows,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(stratified_stats_warp_rows,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kRowBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const Config c = config(m, X);
  if (X > kThreadRowStrata) {
    stratified_stats_warp_rows<<<1, c.threads, c.smem, stream>>>(
        values, strata, mask, m, X, out);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.cs, 1, 1);
  cfg.blockDim = dim3(c.threads, 1, 1);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c.cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, stratified_stats_rows, values, strata, mask,
                           m, X, (m + c.cs - 1) / c.cs, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
