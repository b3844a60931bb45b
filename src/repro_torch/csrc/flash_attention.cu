// Causal GQA flash attention (online softmax) on Hopper.
//
// Replaces repro/kernels/flash_attention/flash_attention.py:
//   flash_attention (body _kernel) -> flash_attention_kernel
//
// What it computes, for q [B, Hq, S, D] and k, v [B, Hkv, S, D] (f32 or
// bf16, contiguous): o = softmax(q k^T / sqrt(D), causal) v per query head
// h, reading kv head h / (Hq / Hkv); nothing is repeated in memory. The
// rounding points are the TPU kernel's (and repro_torch's plain version's,
// kernels/flash_attention/ref.py): kv blocks of BK = min(128, S) columns,
// s = (q . k in f32) * scale, masked entries -1e30, m, l and acc in f32
// with alpha = exp(m_prev - m_cur), p rounded to v's type before P.V,
// o = acc / max(l, 1e-30) in q's type. Because the kv blocks are the plain
// version's, the running max takes the same values at the same points, so
// p is rounded at the same values; only the order of the f32 sums and the
// exp's last bit differ.
//
// What bounds it on this card: operations. Per head 2 S^2 D multiply-adds
// over the causal half (Q.K^T and P.V): 38.7 GFLOP at SmolLM-135M's
// prefill (B 8, Hq 9, S 2048, D 64), 0.039 ms at the tensor cores' 989
// TFLOP/s, against about 50 MB of q, k, v and o (0.015 ms at 3.35 TB/s).
//
// What the design does about it, in this first version: it stays on the
// CUDA cores (67 TFLOP/s f32), a simple kernel that is right; wgmma, TMA
// and a pipelined ring of tiles are for the change that makes it fast.
// One 128-thread block per (b * Hq, 64-row query tile), the longest tiles
// (nearest the end of the sequence) launched first. Each block stages its
// queries in shared memory as f32 and walks the kv blocks up to the
// diagonal; blocks above it are never loaded. Per kv block the K and V
// tile sits in shared memory in its own type (K rows padded to an odd word
// stride, so lanes reading different rows hit different banks). Each warp
// owns 16 query rows and their m, l and acc in registers, four rows at a
// time: lanes split the block's 128 columns for the scores and the head
// dimension for P.V, with warp shuffles for the row max and sum and the
// rounded p staged in shared memory. Multiply-adds are written as
// __fmaf_rn, so the file's -fmad=false (kept for the sampler kernels'
// bitwise arithmetic) does not split them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kRows = 4;                          // rows per pass of a warp
constexpr int kBlockQ = kWarps * kRowsPerWarp;    // 64 query rows per block
constexpr int kMaxBlockK = 128;                   // kv block of the plain version
constexpr int kColsPerLane = kMaxBlockK / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPad = 1;   // K row stride D + 1 words: odd
  __device__ static float get(const float* p) { return *p; }
  __device__ static float2 pair(const float* p) {
    return make_float2(p[0], p[1]);
  }
  __device__ static float round_p(float p) { return p; }
  __device__ static float put(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPad = 2;   // K row stride (D + 2) / 2 words: odd
  __device__ static float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static float round_p(float p) {
    return __bfloat162float(__float2bfloat16_rn(p));
  }
  __device__ static __nv_bfloat16 put(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)kBlockQ * D * sizeof(float)                   // Qs
         + (size_t)kWarps * kRows * kMaxBlockK * sizeof(float)  // Ps
         + (size_t)kMaxBlockK * (D + Elem<T>::kPad) * sizeof(T)  // Ks
         + (size_t)kMaxBlockK * D * sizeof(T);                  // Vs
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// grid (B * Hq, ceil(S / 64)), block 128, dynamic shared memory
// smem_bytes<T, D>().
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int S, int BK, float scale) {
  constexpr int DL = D / 32;                 // head dims per lane in P.V
  constexpr int KS = D + Elem<T>::kPad;      // K row stride in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + kBlockQ * D;
  T* Ks = reinterpret_cast<T*>(Ps + kWarps * kRows * kMaxBlockK);
  T* Vs = Ks + kMaxBlockK * KS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;   // longest tiles first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const T* qb = q + (size_t)bh * S * D;
  const T* kb = k + (size_t)kvh * S * D;
  const T* vb = v + (size_t)kvh * S * D;
  T* ob = o + (size_t)bh * S * D;
  const int q0 = tile * kBlockQ;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D;
    Qs[e] = q0 + r < S ? Elem<T>::get(qb + (size_t)q0 * D + e) : 0.f;
  }
  // Columns past a short block (S < 128) read zeros in P.V.
  for (int e = BK * D + tid; e < kMaxBlockK * D; e += kThreads)
    Vs[e] = Elem<T>::put(0.f);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[r][dd] = 0.f;
  }

  // kv blocks up to the diagonal of the tile's last row.
  const int n_blocks = (min(q0 + kBlockQ, S) - 1) / BK + 1;
  const int bk4 = (BK + 3) & ~3;
  float* pw = Ps + warp * kRows * kMaxBlockK;
  for (int j = 0; j < n_blocks; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // the previous block's tiles are consumed
    for (int e = tid; e < BK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const size_t g = (size_t)k0 * D + e;
      Ks[c * KS + d] = kb[g];
      Vs[e] = vb[g];
    }
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < kRowsPerWarp / kRows; ++pass) {
      const int rl = warp * kRowsPerWarp + pass * kRows;   // tile-local row
      float s[kRows][kColsPerLane];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < kColsPerLane; ++i) s[r][i] = 0.f;
      // s = q . k over the head dimension, lanes over the columns.
#pragma unroll 4
      for (int d = 0; d < D; d += 2) {
        float2 kk[kColsPerLane];
#pragma unroll
        for (int i = 0; i < kColsPerLane; ++i)
          kk[i] = Elem<T>::pair(Ks + (lane + 32 * i) * KS + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float2 qq =
              *reinterpret_cast<const float2*>(Qs + (rl + r) * D + d);
#pragma unroll
          for (int i = 0; i < kColsPerLane; ++i) {
            s[r][i] = __fmaf_rn(qq.x, kk[i].x, s[r][i]);
            s[r][i] = __fmaf_rn(qq.y, kk[i].y, s[r][i]);
          }
        }
      }
      // Scale, causal mask, online softmax; p rounded to v's type.
      float alpha[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int R = pass * kRows + r;
        const int row = q0 + rl + r;
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < kColsPerLane; ++i) {
          const int c = lane + 32 * i;
          const float x = s[r][i] * scale;
          s[r][i] = (c < BK && k0 + c <= row) ? x : kNegInf;
          mx = fmaxf(mx, s[r][i]);
        }
        const float m_cur = fmaxf(m[R], warp_max(mx));
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < kColsPerLane; ++i) {
          const int c = lane + 32 * i;
          const float p = c < BK ? expf(s[r][i] - m_cur) : 0.f;
          psum += p;
          pw[r * kMaxBlockK + c] = Elem<T>::round_p(p);
        }
        alpha[r] = expf(m[R] - m_cur);
        l[R] = l[R] * alpha[r] + warp_sum(psum);
        m[R] = m_cur;
      }
      __syncwarp();
      // P.V, lanes over the head dimension.
      float pv[kRows][DL];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) pv[r][dd] = 0.f;
      for (int c = 0; c < bk4; c += 4) {
        float vv[4][DL];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int dd = 0; dd < DL; ++dd)
            vv[cc][dd] = Elem<T>::get(Vs + (c + cc) * D + lane + 32 * dd);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(pw + r * kMaxBlockK + c);
          const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int dd = 0; dd < DL; ++dd)
              pv[r][dd] = __fmaf_rn(pp[cc], vv[cc][dd], pv[r][dd]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) {
          const int R = pass * kRows + r;
          acc[R][dd] = acc[R][dd] * alpha[r] + pv[r][dd];
        }
      __syncwarp();   // pw is rewritten by the next pass
    }
  }

#pragma unroll
  for (int R = 0; R < kRowsPerWarp; ++R) {
    const int row = q0 + warp * kRowsPerWarp + R;
    if (row < S) {
      const float denom = fmaxf(l[R], 1e-30f);
#pragma unroll
      for (int dd = 0; dd < DL; ++dd)
        ob[(size_t)row * D + lane + 32 * dd] = Elem<T>::put(acc[R][dd] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int S, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (S + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, S,
      S < kMaxBlockK ? S : kMaxBlockK, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int S, int d, float scale, cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, S, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, S, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [b, hq, s, d], k and v [b, hkv, s, d], o like q; all contiguous, f32
// (bf16 = 0) or bf16 (bf16 = 1); d in {32, 64, 128}; hq a multiple of hkv;
// s a multiple of min(128, s). scale: 1/sqrt(d) rounded to f32.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int hq, int hkv, int s, int d,
                           int bf16, float scale, cudaStream_t stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || s < 1 ||
      s % (s < kMaxBlockK ? s : kMaxBlockK) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, d, scale,
                                        stream)
              : launch_d<float>(q, k, v, o, b, hq, hkv, s, d, scale, stream);
}

}  // extern "C"
