// Causal GQA flash attention (online softmax) on Hopper.
//
// Replaces repro/kernels/flash_attention/flash_attention.py:
//   flash_attention (body _kernel) -> flash_attention_tc_kernel (bf16)
//                                     flash_attention_kernel    (f32)
//
// What it computes, for q [B, Hq, S, D] and k, v [B, Hkv, S, D] (bf16 or
// f32, contiguous): o = softmax(q k^T / sqrt(D), causal) v per query head
// h, reading kv head h / (Hq / Hkv); nothing is repeated in memory. The
// rounding points are the TPU kernel's (and repro_torch's plain version's,
// kernels/flash_attention/ref.py): kv blocks of BK = min(128, S) columns,
// s = (q . k in f32) * scale, masked entries -1e30, m, l and acc in f32
// with m_cur = max(m_prev, rowmax), p = exp(s - m_cur), alpha =
// exp(m_prev - m_cur), l = l * alpha + sum(p) with p unrounded, p rounded
// to v's type before P.V, o = acc / max(l, 1e-30) in q's type.
//
// What bounds it on this card: operations. Per head 2 S^2 D multiply-adds
// over the causal half (Q.K^T and P.V): 38.7 GFLOP at SmolLM-135M's
// prefill (B 8, Hq 9, S 2048, D 64), 0.039 ms at the tensor cores' 989
// TFLOP/s, against about 50 MB of q, k, v and o (0.015 ms at 3.35 TB/s).
//
// The two kernels, chosen by dtype alone in flash_attention_launch:
//
// bf16 -> flash_attention_tc_kernel, on the tensor cores. One CTA per
// (b * Hq, 128-row query tile), the longest tiles (nearest the end of the
// sequence) launched first; 384 threads: a producer warpgroup and two
// consumer warpgroups of 64 query rows each. setmaxnreg gives the
// producer 40 registers and the consumers 232.
//   Loads: one producer thread issues TMA loads through 3-D tensor maps
//   (head, row, dim), so a 128-row box past S reads zeros, not the next
//   head's rows. Q is loaded once; K and V in tiles of 128 kv rows x D into
//   a ring of kStages slots, each with full barriers (K and V apart, so
//   Q.K^T starts while V lands) and an empty barrier that both consumer
//   warpgroups release after their P.V. Swizzle: 128 bytes at D = 64 (a
//   row is 128 bytes), two 64-column atoms at D = 128, 64 bytes at D = 32;
//   the wgmma descriptors name the same layout.
//   S = Q.K^T: per consumer warpgroup one wgmma.m64n128k16 chain over the
//   head dimension, both operands from shared memory (K-major), f32
//   accumulators in registers.
//   Softmax in registers: a thread holds rows r and r + 8 of its warp's 16
//   (32 of the 128 columns each), so a row's max and sum take two
//   __shfl_xor_sync steps inside the quad. Only the diagonal block (the
//   last of the tile) is masked; blocks past it are never loaded.
//   P.V: p is rounded to bf16 in registers; the S accumulator's fragment,
//   packed in bf16 pairs, is exactly the A fragment of a k16 step (regs
//   8kk .. 8kk + 7 for kv columns 16kk .. 16kk + 15), so the P.V wgmma
//   takes A from registers and V from shared memory as an N-major B
//   operand (transpose bit set), n = D (two n64 halves at D = 128). The
//   accumulator is scaled by alpha first and the wgmma adds P.V to it.
//   p rounds as the plain version's (verified rounding). The tensor cores
//   sum q . k in another order than the plain version's f32 matmul (a
//   sequential FMA chain over d), and in the rows with few keys one bf16
//   step of one p moves an output by more than its own ulp: with the
//   scores alone differing in their last bits, outputs land two ulps from
//   the plain version's (the plain version with its scores summed in f64
//   does too). So the kernel keeps a bound on how far each score may lie
//   from the plain version's, u sum_d w_d |q_d k_d| (err_weight: the
//   chain's roundings, and the tensor cores' k16 steps: each aligns its 16
//   exact products and the accumulator to the largest, cuts each at 2^-25
//   of it and truncates the sum to f32, so a step errs by less than
//   (17 / 2 + 2) u of its terms and the accumulator; measured up to 8.94
//   u by tools/wgmma_error_probe.py). At D <= 64
//   the tensor cores compute it for every score as a second product,
//   (|q| w) . |k|, with |K| tiles that the idle producer warps write; at
//   D = 128 (no shared memory left for them) it is Cauchy-Schwarz with the
//   K tile's largest column norms, which those warps compute. An element
//   whose p lies within that reach of a bf16 rounding midpoint, or whose
//   score may be the plain version's new row max, is rescored in the plain
//   version's order by the warp, its elements dealt out to its lanes
//   (rescore); the plain version's running max is kept exactly, p is
//   rounded as the plain version rounds it (expf, then bf16), and a p that
//   differs is patched before P.V. Few elements are rescored, and of
//   those very few change. The bulk p is ex2 of
//   (x - m) log2 e, its error inside the reach; p below e^-12 is outside
//   it (one bf16 step of such a p moves an output by less than 2^-24 of
//   the largest |v|).
//   Short sequences (S < 128, BK = S) take the same path: rows and columns
//   past S come in as zeros, columns past a row (and so past S) are masked
//   to -1e30, and rows past S are not stored.
//   A barrier wait that lasts kWaitNs is a broken protocol, not a slow
//   one: the kernel traps, and the launch fails with an error, rather than
//   hang the card.
//
// f32 -> flash_attention_kernel, on the CUDA cores (67
// TFLOP/s f32). wgmma has no f32 form, and TF32 would round q and k to 10
// mantissa bits, which the f32 checks (1e-5 against the plain version;
// the f32 prefill within 1e-3 of its largest logit) do not allow. One
// 128-thread block per (b * Hq, 64-row query tile), longest tiles first;
// the queries staged in shared memory, the K and V tiles of each kv block
// up to the diagonal in shared memory (K rows padded to an odd word
// stride); each warp owns 16 query rows and their m, l and acc in
// registers, four rows at a time: lanes split the block's columns for the
// scores and the head dimension for P.V, warp shuffles for the row max and
// sum, p staged in shared memory. Its q . k is the same sequential chain
// as the plain version's, so its p round as the plain version's.
//
// Multiply-adds are written as __fmaf_rn, so the file's -fmad=false (kept
// for the sampler kernels' bitwise arithmetic) does not split them, and
// the softmax's l * alpha + sum(p) and acc * alpha stay two roundings as
// in the plain version. The tensor-map encoder is looked up with
// cudaGetDriverEntryPoint, so the library links no -lcuda.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlockK = 128;   // kv block of the plain version

// Query head bh % Hq of batch bh / Hq reads this kv head (of B * Hkv).
__device__ __forceinline__ int kv_head(int bh, int hq, int hkv) {
  return (bh / hq) * hkv + (bh % hq) / (hq / hkv);
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA.

constexpr int kTileRows = 128;       // query rows per CTA; kv rows per stage
constexpr int kStages = 2;
constexpr int kTcThreads = 3 * 128;  // producer + two consumer warpgroups
constexpr int kNormWarps = 3;        // producer warps 1-3: |K| or norms
constexpr unsigned long long kWaitNs = 4000000000ull;
constexpr int kList = 128;           // elements a warp rescores per pass
constexpr float kLog2e = 1.4426950408889634f;
// Unit roundoff 2^-24, with 6% to spare for the rounding of the norms and
// the bound's second-order terms.
constexpr float kErr = 1.06f * 5.9604645e-8f;

template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;        // columns per atom
  static constexpr int kRowBytes = 2 * kCols;          // 64 or 128
  static constexpr int kSub = D / kCols;               // atoms across D
  static constexpr int kSubBytes = kTileRows * kRowBytes;
  static constexpr int kBytes = kSub * kSubBytes;      // one 128 x D tile
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte.
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
};

// A consumer warp's scratch for rescoring: its packed bf16 p ([element / 8]
// [lane]), the elements of one pass and their rescored x, the plain
// version's running max of its 16 rows, and whether a pass changed a p.
struct WarpScratch {
  uint4 p[8][32];
  uint32_t ent[kList];
  float val[kList];
  float m[16];
  int patched;
};

template <int D>
constexpr size_t tc_smem_bytes() {
  return 1024                                          // alignment slack
         + (size_t)(1 + 2 * kStages) * Tile<D>::kBytes  // Q, K and V ring
         // D <= 64: the |q| w tile and the |K| ring
         + (D <= 64 ? (size_t)(1 + kStages) * Tile<D>::kBytes : 0)
         + 8 * 32                                      // mbarriers
         + sizeof(float2) * 8                          // K column norms
         + sizeof(WarpScratch) * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = now_ns();
  while (!mbar_try(a, parity))
    if (now_ns() - t0 > kWaitNs) __trap();
}

// One TMA box (cols x 128 rows x 1 head) at (col, row, head) into dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor of a swizzled tile at smem address a:
// start >> 4; the stride offset, 8 rows of the tile, between the 8-row
// groups; the layout type. The leading offset (between swizzle atoms
// along the contiguous dimension) is never used here: a K-major operand's
// k16 step lies inside one 128- or 64-byte row, and V spans one atom
// along N per wgmma. It is 16 bytes for K-major operands, and the 8-row
// stride for V (N-major), as both readings of the field agree on then.
template <int D, bool kMnMajor>
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  constexpr uint64_t stride = (8 * Tile<D>::kRowBytes) >> 4;
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((kMnMajor ? stride : (uint64_t)1) << 16) | (stride << 32) |
         (Tile<D>::kLayout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keep the compiler from moving accumulator reads across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)

// d (+)= A B, m64n128k16: A (64 x 16, K-major) and B (128 x 16, K-major)
// from shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16 / m64n32k16: A (64 x 16) from registers, B (16 x N)
// from shared memory, N-major (transpose bit set).
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : F16(0), F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[16],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef F16
#undef F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// 8 bf16 (16 bytes) of a swizzled tile: row `row`, head dims 8 c8 ..
// 8 c8 + 7. The 16-byte chunks of a row are permuted by the row's place
// in its 8-row (128-byte swizzle) or 4-row-pair (64-byte) pattern.
template <int D>
__device__ __forceinline__ uint4 tile_chunk(const unsigned char* tile,
                                            int row, int c8) {
  using L = Tile<D>;
  constexpr int kChunks = L::kCols / 8;
  const int sw = L::kRowBytes == 128 ? (row & 7) : ((row >> 1) & 3);
  return *reinterpret_cast<const uint4*>(
      tile + (c8 / kChunks) * L::kSubBytes + row * L::kRowBytes +
      (((c8 % kChunks) ^ sw) << 4));
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The weight of a term q_d k_d in a score's error bound, in u: the D - d
// roundings it passes through in the plain version's FMA chain, and 11
// for each tensor-core k16 step from its own to the last (a step errs by
// less than 10.5 u of its products and the accumulator, which holds every
// earlier term). At most 216 at D = 128, so w x is exact in f32 for a
// bf16 x.
template <int D>
__device__ __forceinline__ float err_weight(int d) {
  return (float)(D - d + 11 * (D / 16 - d / 16));
}

// sum_d err_weight(d) x_d^2 over row `row` of a swizzled tile.
template <int D>
__device__ __forceinline__ float weighted_norm2(const unsigned char* tile,
                                                int row) {
  float b = 0.f;
#pragma unroll 2
  for (int c8 = 0; c8 < D / 8; ++c8) {
    const uint4 q = tile_chunk<D>(tile, row, c8);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = bf_lo(w[e]), x1 = bf_hi(w[e]);
      const int d = 8 * c8 + 2 * e;
      b = __fmaf_rn(err_weight<D>(d) * x0, x0, b);   // products exact
      b = __fmaf_rn(err_weight<D>(d + 1) * x1, x1, b);
    }
  }
  return b;
}

// The plain version's score q_row . k_col: its f32 matmul (cuBLAS) sums
// it as one FMA chain over the head dimension in order, from 0, and so
// does this. The loads of a batch of 8 chunks are issued together, so the
// score waits on shared memory once a batch, not once a chunk.
template <int D>
__device__ __forceinline__ float seq_score(const unsigned char* Q,
                                           const unsigned char* K, int row,
                                           int col) {
  constexpr int kB = D / 8 < 8 ? D / 8 : 8;
  float acc = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < D / 8; c0 += kB) {
    uint4 a[kB], b[kB];
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      a[c] = tile_chunk<D>(Q, row, c0 + c);
      b[c] = tile_chunk<D>(K, col, c0 + c);
    }
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      const uint32_t aw[4] = {a[c].x, a[c].y, a[c].z, a[c].w};
      const uint32_t bw[4] = {b[c].x, b[c].y, b[c].z, b[c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc = __fmaf_rn(bf_lo(aw[e]), bf_lo(bw[e]), acc);
        acc = __fmaf_rn(bf_hi(aw[e]), bf_hi(bw[e]), acc);
      }
    }
  }
  return acc;
}

__device__ __forceinline__ float ex2_fast(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int warp_excl_scan(int x, int lane, int* total) {
  int s = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, s, d);
    if (lane >= d) s += y;
  }
  *total = __shfl_sync(kFull, s, 31);
  return s - x;
}

// A warp's rescoring of one block. Each lane marks elements of its
// fragment (bit i: element i) in `cand` (within reach of its rows' block
// max, where that max may pass the plain version's running max m_seq) and
// `flag` (p within reach of a bf16 rounding midpoint). The marked elements
// are dealt out to the warp's lanes, candidates first, kList a pass; a
// lane scores its element as the plain version does (x = q.k summed in
// order, times scale). Once every candidate is scored, m_seq is updated to
// the plain version's max; then each scored element's p is rounded as the
// plain version rounds it, bf16(expf(x - m_seq)), and where that differs
// from the element's half of its word in ws->p, the half is patched.
template <int D>
__device__ __forceinline__ void rescore(WarpScratch* ws, int lane,
                                        const unsigned char* Qs,
                                        const unsigned char* Kt, int rw,
                                        int q0, int kv0, bool diag,
                                        float scale, uint64_t cand,
                                        uint64_t flag, const bool (&need)[2],
                                        float (&m_seq)[2]) {
  // One scan of both counts (candidates low, flagged-only high): the
  // lane's first slots and the warp's totals. Past one pass of
  // candidates, a candidate is checked as a flagged element too.
  int total, Tf;
  const int both = warp_excl_scan(
      __popcll(cand) | (__popcll(flag & ~cand) << 16), lane, &total);
  const int Tc = total & 0xffff, oc = both & 0xffff;
  int of = both >> 16;
  Tf = total >> 16;
  if (Tc > kList) {
    flag |= cand;
    of = warp_excl_scan(__popcll(flag), lane, &Tf);
  } else {
    flag &= ~cand;
  }
  of += Tc;
  const int T = Tc + Tf;
  // Element i of lane `owner`: its row in the tile, its column in the
  // block, and whether it lies above the diagonal.
  auto row_of = [&](int owner, int i) {
    return rw + owner / 4 + 8 * ((i >> 1) & 1);
  };
  auto col_of = [&](int owner, int i) {
    return 8 * (i >> 2) + 2 * (owner % 4) + (i & 1);
  };
  auto masked = [&](int owner, int i) {
    return diag && kv0 + col_of(owner, i) > q0 + row_of(owner, i);
  };
  float cm[2] = {kNegInf, kNegInf};
  bool have_max = Tc == 0;
  if (have_max && lane % 4 == 0) {
    ws->m[lane / 4] = m_seq[0];
    ws->m[lane / 4 + 8] = m_seq[1];
  }
  for (int base = 0; base < T; base += kList) {
    int r = oc;
    for (uint64_t m = cand; m; m &= m - 1, ++r)
      if (r >= base && r < base + kList)
        ws->ent[r - base] = (lane << 6) | (__ffsll((long long)m) - 1);
    r = of;
    for (uint64_t m = flag; m; m &= m - 1, ++r)
      if (r >= base && r < base + kList)
        ws->ent[r - base] = (lane << 6) | (__ffsll((long long)m) - 1);
    __syncwarp();
    const int n = min(kList, T - base);
    for (int k = lane; k < n; k += 32) {
      const int owner = ws->ent[k] >> 6, i = ws->ent[k] & 63;
      ws->val[k] =
          seq_score<D>(Qs, Kt, row_of(owner, i), col_of(owner, i)) * scale;
    }
    __syncwarp();
    if (!have_max) {
      r = oc;
      for (uint64_t m = cand; m; m &= m - 1, ++r)
        if (r >= base && r < base + kList) {
          const int i = __ffsll((long long)m) - 1;
          if (!masked(lane, i))
            cm[(i >> 1) & 1] = fmaxf(cm[(i >> 1) & 1], ws->val[r - base]);
        }
      if (base + kList >= Tc) {   // every candidate is scored
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          cm[q] = quad_max(cm[q]);
          if (need[q]) m_seq[q] = fmaxf(m_seq[q], cm[q]);
        }
        if (lane % 4 == 0) {
          ws->m[lane / 4] = m_seq[0];
          ws->m[lane / 4 + 8] = m_seq[1];
        }
        have_max = true;
        __syncwarp();
      }
    }
    if (have_max) {
      for (int k = lane; k < n; k += 32) {
        if (Tc > kList && base + k < Tc) continue;   // checked as flagged
        const int owner = ws->ent[k] >> 6, i = ws->ent[k] & 63;
        const __nv_bfloat16 want = __float2bfloat16_rn(
            masked(owner, i)
                ? 0.f
                : expf(ws->val[k] - ws->m[row_of(owner, i) - rw]));
        __nv_bfloat16* half =
            reinterpret_cast<__nv_bfloat16*>(&ws->p[i / 8][owner]) + i % 8;
        if (__bfloat16_as_ushort(want) != __bfloat16_as_ushort(*half)) {
          *half = want;
          ws->patched = 1;
        }
      }
    }
    __syncwarp();
  }
}

// grid (B * Hq, ceil(S / 128)), block 384, dynamic shared memory
// tc_smem_bytes<D>(). An accumulator element i of a consumer thread (warp
// w of its warpgroup, lane l) is row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2 of its m64nN tile.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, int hq, int hkv,
                          int S, float scale) {
  using L = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  // Swizzle patterns repeat every 1024 bytes of address; TMA and wgmma
  // both apply them from the address bits, so tiles start 1024-aligned.
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + L::kBytes;
  unsigned char* Vs = Ks + kStages * L::kBytes;
  // D <= 64: each score's error bound comes from the tensor cores, as
  // (|q| w) . |k| over a tile Qw of |q_d| err_weight(d) (rounded up) and a
  // ring Ka of |K| tiles; at D = 128 there is no room for them, and the
  // bound takes the K tile's largest weighted row norm instead.
  constexpr bool kExact = D <= 64;
  unsigned char* Qw = Vs + kStages * L::kBytes;
  unsigned char* Ka = Qw + (kExact ? L::kBytes : 0);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      Ka + (kExact ? kStages * L::kBytes : 0));
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  uint64_t* norm_full = empty + kStages;
  float* knorm = reinterpret_cast<float*>(q_full + 32);   // [st][warp]
  WarpScratch* scratch = reinterpret_cast<WarpScratch*>(knorm + 16);

  const int bh = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;   // longest tiles first
  const int q0 = tile * kTileRows;
  const int n_blocks = tile + 1;   // kv blocks 0 .. the diagonal
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2 * 128);   // every consumer thread releases
      mbar_init(&norm_full[s], kNormWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pw = threadIdx.x / 32;
    if (threadIdx.x == 0) {
      // Producer: one thread keeps the ring full.
      const int kvh = kv_head(bh, hq, hkv);
      mbar_expect_tx(q_full, L::kBytes);
      for (int h = 0; h < L::kSub; ++h)
        tma_load(Qs + h * L::kSubBytes, &tq, q_full, h * L::kCols, q0, bh);
      for (int j = 0; j < n_blocks; ++j) {
        const int st = j % kStages;
        const uint32_t lap = j / kStages;
        mbar_wait(&empty[st], (lap & 1) ^ 1);   // the first lap passes
        unsigned char* kd = Ks + st * L::kBytes;
        unsigned char* vd = Vs + st * L::kBytes;
        mbar_expect_tx(&k_full[st], L::kBytes);
        for (int h = 0; h < L::kSub; ++h)
          tma_load(kd + h * L::kSubBytes, &tk, &k_full[st], h * L::kCols,
                   j * kTileRows, kvh);
        mbar_expect_tx(&v_full[st], L::kBytes);
        for (int h = 0; h < L::kSub; ++h)
          tma_load(vd + h * L::kSubBytes, &tv, &v_full[st], h * L::kCols,
                   j * kTileRows, kvh);
      }
    } else if (pw >= 1) {
      // Warps 1-3: for the consumers' bound on their scores, each K tile
      // with its signs cleared (D <= 64), or its largest weighted row
      // norm. The consumers release the slot only after
      // these are done, so the reads of K here end before it is refilled.
      const int lane = threadIdx.x % 32;
      for (int j = 0; j < n_blocks; ++j) {
        const int st = j % kStages;
        mbar_wait(&k_full[st], (j / kStages) & 1);
        if constexpr (kExact) {
          const uint4* src =
              reinterpret_cast<const uint4*>(Ks + st * L::kBytes);
          uint4* dst = reinterpret_cast<uint4*>(Ka + st * L::kBytes);
          for (int c = threadIdx.x - 32; c < L::kBytes / 16;
               c += 32 * kNormWarps) {
            const uint4 v = src[c];
            dst[c] = make_uint4(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu,
                                v.z & 0x7fff7fffu, v.w & 0x7fff7fffu);
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(&norm_full[st]);
          continue;
        }
        float mx = 0.f;
        for (int c = threadIdx.x - 32; c < kTileRows; c += 32 * kNormWarps)
          mx = fmaxf(mx, weighted_norm2<D>(Ks + st * L::kBytes, c));
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, d));
        if (lane == 0) {
          knorm[st * kNormWarps + pw - 1] = sqrtf(mx);
          mbar_arrive(&norm_full[st]);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int rw = 64 * cw + 16 * (t / 32);   // the warp's first tile row
  const int rl = rw + lane / 4;             // this thread's rows rl, rl + 8
  const int c0 = 2 * (lane % 4);
  const uint32_t q_s = smem_u32(Qs) + cw * 64 * L::kRowBytes;
  WarpScratch* ws = scratch + threadIdx.x / 32 - 4;
  constexpr int kOn = L::kCols / 2;      // accumulators per n = kCols part

  // m_seq is the plain version's running max of x = fl(s_seq scale),
  // exact; m is the reference the kernel's p, l and acc are taken against:
  // m_seq, unless a block's scores may pass it (then the block's max).
  float m[2] = {kNegInf, kNegInf}, m_seq[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[L::kSub][kOn];
#pragma unroll
  for (int h = 0; h < L::kSub; ++h)
#pragma unroll
    for (int i = 0; i < kOn; ++i) acc[h][i] = 0.f;
  if (lane == 0) ws->patched = 0;
  const float cL = scale * kLog2e, inv_scale = 1.f / scale;

  mbar_wait(q_full, 0);
  float qnw[2];   // weighted norms of the thread's two query rows
  if constexpr (kExact) {
    // This warp's 16 rows of Qw: |q_d| err_weight(d), rounded up to bf16,
    // in Q's swizzled layout; the warpgroup's 64 rows are complete before
    // its first bound product.
    for (int c = lane; c < 16 * (D / 8); c += 32) {
      const int row = rw + c / (D / 8), pc = c % (D / 8);
      const int sw = L::kRowBytes == 128 ? (row & 7) : ((row >> 1) & 3);
      const int off = row * L::kRowBytes + pc * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(Qs + off);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[4];
      const int d0 = 8 * (pc ^ sw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = fabsf(bf_lo(w[e])) * err_weight<D>(d0 + 2 * e);
        const float hi = fabsf(bf_hi(w[e])) * err_weight<D>(d0 + 2 * e + 1);
        const __nv_bfloat162 r2 = make_bfloat162(__float2bfloat16_ru(lo),
                                                 __float2bfloat16_ru(hi));
        o[e] = *reinterpret_cast<const uint32_t*>(&r2);
      }
      *reinterpret_cast<uint4*>(Qw + off) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      qnw[r] = sqrtf(weighted_norm2<D>(Qs, rl + 8 * r));
  }

  for (int j = 0; j < n_blocks; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const unsigned char* Kt = Ks + st * L::kBytes;
    const uint32_t k_s = smem_u32(Kt);
    const uint32_t v_s = smem_u32(Vs + st * L::kBytes);

    // S = Q K^T over the head dimension, k16 steps; at D <= 64 also the
    // bound B = (|q| w) . |k| of each score.
    float s[64], bnd[kExact ? 64 : 1];
    mbar_wait(&k_full[st], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk * 16 / L::kCols) * L::kSubBytes +
                           (kk * 16 % L::kCols) * 2;
      wgmma_qk(s, desc<D, false>(q_s + off), desc<D, false>(k_s + off),
               kk > 0);
    }
    wg_commit();
    mbar_wait(&norm_full[st], parity);
    if constexpr (kExact) {
      const uint32_t qw_s = smem_u32(Qw) + cw * 64 * L::kRowBytes;
      const uint32_t ka_s = smem_u32(Ka + st * L::kBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 16 / L::kCols) * L::kSubBytes +
                             (kk * 16 % L::kCols) * 2;
        wgmma_qk(bnd, desc<D, false>(qw_s + off), desc<D, false>(ka_s + off),
                 kk > 0);
      }
      wg_commit();
      wg_wait_one();   // the scores; the bound may still be running
    } else {
      wg_wait();
    }
    fence_regs(s);

    // How far a score x = s scale may lie from the plain version's:
    // u sum_d err_weight(d) |q_d k_d| times scale. At D <= 64 that is B
    // (times 1 + 2^-16 for B's own roundings); at D = 128 Cauchy-Schwarz
    // bounds it by |q|_w |k|_w, with the block's largest weighted norm.
    float kmax = 0.f;
    if constexpr (!kExact) {
      kmax = knorm[st * kNormWarps];
#pragma unroll
      for (int w = 1; w < kNormWarps; ++w)
        kmax = fmaxf(kmax, knorm[st * kNormWarps + w]);
    }
    const float c_err = kErr * 1.0001f * scale;

    // Mask the diagonal block; the block's row max.
    const int kv0 = j * kTileRows;
    const bool diag = j == n_blocks - 1;
    if (diag) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = kv0 + 8 * (i / 4) + c0 + (i & 1);
        const int row = q0 + rl + 8 * ((i >> 1) & 1);
        if (col > row) s[i] = kNegInf;
      }
    }
    float bm4[8];   // four chains a row: element i feeds chain i % 8
#pragma unroll
    for (int c = 0; c < 8; ++c) bm4[c] = s[c];
#pragma unroll
    for (int i = 8; i < 64; ++i) bm4[i % 8] = fmaxf(bm4[i % 8], s[i]);
    float bm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)   // chains c with (c >> 1) & 1 == r
      bm[r] = fmaxf(fmaxf(bm4[2 * r], bm4[2 * r + 1]),
                    fmaxf(bm4[2 * r + 4], bm4[2 * r + 5]));

    float bmax[2] = {0.f, 0.f};   // each row's largest bound
    if constexpr (kExact) {
      wg_wait();
      fence_regs(bnd);
      float b8[8];   // four chains a row, as for bm
#pragma unroll
      for (int c = 0; c < 8; ++c) b8[c] = bnd[c];
#pragma unroll
      for (int i = 8; i < 64; ++i) b8[i % 8] = fmaxf(b8[i % 8], bnd[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bmax[r] = fmaxf(fmaxf(b8[2 * r], b8[2 * r + 1]),
                        fmaxf(b8[2 * r + 4], b8[2 * r + 5]));
    }
    float alpha[2], mL[2], dn[2], up[2], lo[2], base[2];
    bool need[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bm[r] = quad_max(bm[r]);
      const float err =
          kExact ? c_err * quad_max(bmax[r])
                 : c_err * qnw[r] * kmax;
      // May a score of this block, within its reach, pass m_seq? Then
      // its candidates are rescored, and p is taken against the block's
      // max, at most wm from the plain version's new one.
      const float bx = bm[r] * scale;
      const float wm = err + 0x1p-22f * (fabsf(bx) + 1.f);
      need[r] = bx + wm > m_seq[r];
      lo[r] = need[r] ? bm[r] - 2.f * wm * inv_scale : -kNegInf;
      const float m_new = need[r] ? fmaxf(m_seq[r], bx) : m_seq[r];
      mL[r] = m_new * kLog2e;
      alpha[r] = ex2_fast(__fmaf_rn(m[r], kLog2e, -mL[r]));
      m[r] = m_new;
      // p's reach: err, the distance of m from the plain version's max
      // (wm or 0), and the roundings of x, x - m, the ex2 argument (2^-24
      // of |m| and of |x - m| each, seven in all) and ex2's and expf's
      // errors (2^-22, 2^-23), for |x - m| <= 12. A p below e^-12 is not
      // covered: one bf16 step of it moves an output by less than 2^-24
      // of the largest |v|.
      base[r] = 1.02f * ((need[r] ? wm : 0.f) +
                         0x1p-21f * (fabsf(m_new) + 12.f));
      const float wp = 1.02f * err + base[r];
      dn[r] = 1.f - wp;
      up[r] = 1.f + wp;
    }

    // p = exp(x - m) by ex2, its sum unrounded, rounded to bf16 pairs;
    // an element is flagged where [p dn, p up] holds a bf16 rounding
    // midpoint, a candidate where it may be the plain version's new max.
    float sum[4] = {0.f, 0.f, 0.f, 0.f};   // two chains a row
    uint32_t p[32];
    uint64_t flagged = 0, cand = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {   // s[2i], s[2i + 1]: row half i % 2
      const int r = i & 1;
      const float p0 = ex2_fast(__fmaf_rn(s[2 * i], cL, -mL[r]));
      const float p1 = ex2_fast(__fmaf_rn(s[2 * i + 1], cL, -mL[r]));
      sum[r] += p0;
      sum[r + 2] += p1;
      p[i] = pack_bf16(p0, p1);
      uint32_t d;
      if constexpr (kExact) {   // each element's own reach
        const float w0 = __fmaf_rn(1.02f * c_err, bnd[2 * i], base[r]);
        const float w1 = __fmaf_rn(1.02f * c_err, bnd[2 * i + 1], base[r]);
        d = pack_bf16(__fmaf_rn(-w0, p0, p0), __fmaf_rn(-w1, p1, p1)) ^
            pack_bf16(__fmaf_rn(w0, p0, p0), __fmaf_rn(w1, p1, p1));
      } else {
        d = pack_bf16(p0 * dn[r], p1 * dn[r]) ^
            pack_bf16(p0 * up[r], p1 * up[r]);
      }
      if (d & 0xffffu) flagged |= 1ull << (2 * i);
      if (d >> 16) flagged |= 1ull << (2 * i + 1);
      if (s[2 * i] >= lo[r]) cand |= 1ull << (2 * i);
      if (s[2 * i + 1] >= lo[r]) cand |= 1ull << (2 * i + 1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * alpha[r] + quad_sum(sum[r] + sum[r + 2]);
#pragma unroll
    for (int h = 0; h < L::kSub; ++h)
#pragma unroll
      for (int i = 0; i < kOn; ++i)
        acc[h][i] = acc[h][i] * alpha[(i >> 1) & 1];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      ws->p[q][lane] = make_uint4(p[4 * q], p[4 * q + 1], p[4 * q + 2],
                                  p[4 * q + 3]);

    // Elements whose p could round otherwise than the plain version's are
    // rescored and patched; the warp then reloads its P fragment.
    __syncwarp();
    rescore<D>(ws, lane, Qs, Kt, rw, q0, kv0, diag, scale, cand, flagged,
               need, m_seq);
    if (ws->patched) {   // the same for the whole warp
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 w = ws->p[q][lane];
        p[4 * q] = w.x;
        p[4 * q + 1] = w.y;
        p[4 * q + 2] = w.z;
        p[4 * q + 3] = w.w;
      }
      __syncwarp();
      if (lane == 0) ws->patched = 0;
    }

    // acc += P V: kv columns 16 kk .. 16 kk + 15 are p[4 kk .. 4 kk + 3].
    mbar_wait(&v_full[st], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk)
#pragma unroll
      for (int h = 0; h < L::kSub; ++h)
        wgmma_pv(acc[h], &p[4 * kk],
                 desc<D, true>(v_s + h * L::kSubBytes +
                               kk * 16 * L::kRowBytes));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int h = 0; h < L::kSub; ++h) fence_regs(acc[h]);
    mbar_arrive(&empty[st]);
  }

  __nv_bfloat16* ob = o + (size_t)bh * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int h = 0; h < L::kSub; ++h)
#pragma unroll
      for (int c = 0; c < L::kCols / 8; ++c) {
        const int col = h * L::kCols + 8 * c + c0;
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + col) =
            __floats2bfloat162_rn(acc[h][4 * c + 2 * r] / denom,
                                  acc[h][4 * c + 2 * r + 1] / denom);
      }
  }
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// x [heads, S, D] bf16 as a 3-D tensor map (dim, row, head) with boxes of
// kCols x 128 rows x 1 head, swizzled as the wgmma descriptors read them.
template <int D>
bool tensor_map(CUtensorMap* map, const void* x, int S, int heads) {
  using L = Tile<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::kCols, (cuuint32_t)kTileRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int hq, int hkv, int S, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map<D>(&tq, q, S, b * hq) ||
      !tensor_map<D>(&tk, k, S, b * hkv) ||
      !tensor_map<D>(&tv, v, S, b * hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (S + kTileRows - 1) / kTileRows);
  flash_attention_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), hq, hkv, S, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA cores.

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kRows = 4;                          // rows per pass of a warp
constexpr int kBlockQ = kWarps * kRowsPerWarp;    // 64 query rows per block
constexpr int kColsPerLane = kMaxBlockK / 32;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)kBlockQ * D * sizeof(float)                   // Qs
         + (size_t)kWarps * kRows * kMaxBlockK * sizeof(float)  // Ps
         + (size_t)kMaxBlockK * (D + 1) * sizeof(float)         // Ks
         + (size_t)kMaxBlockK * D * sizeof(float);              // Vs
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
// smem_bytes<D>().
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int hq, int hkv, int S, int BK, float scale) {
  constexpr int DL = D / 32;                 // head dims per lane in P.V
  constexpr int KS = D + 1;                  // K row stride in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + kBlockQ * D;
  float* Ks = Ps + kWarps * kRows * kMaxBlockK;
  float* Vs = Ks + kMaxBlockK * KS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;   // longest tiles first
  const int kvh = kv_head(bh, hq, hkv);
  const float* qb = q + (size_t)bh * S * D;
  const float* kb = k + (size_t)kvh * S * D;
  const float* vb = v + (size_t)kvh * S * D;
  float* ob = o + (size_t)bh * S * D;
  const int q0 = tile * kBlockQ;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D;
    Qs[e] = q0 + r < S ? qb[(size_t)q0 * D + e] : 0.f;
  }
  // Columns past a short block (S < 128) read zeros in P.V.
  for (int e = BK * D + tid; e < kMaxBlockK * D; e += kThreads) Vs[e] = 0.f;

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
        for (int i = 0; i < kColsPerLane; ++i) {
          const float* kp = Ks + (lane + 32 * i) * KS + d;
          kk[i] = make_float2(kp[0], kp[1]);
        }
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
      // Scale, causal mask, online softmax.
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
          pw[r * kMaxBlockK + c] = p;
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
            vv[cc][dd] = Vs[(c + cc) * D + lane + 32 * dd];
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
        ob[(size_t)row * D + lane + 32 * dd] = acc[R][dd] / denom;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int S, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (S + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, S,
      S < kMaxBlockK ? S : kMaxBlockK, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int S, int bf16, float scale, cudaStream_t st) {
  return bf16 ? launch_tc<D>(q, k, v, o, b, hq, hkv, S, scale, st)
              : launch_f32<D>(q, k, v, o, b, hq, hkv, S, scale, st);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [b, hq, s, d], k and v [b, hkv, s, d], o like q; all contiguous and
// 16-byte aligned, f32 (bf16 = 0: the CUDA-core kernel) or bf16 (bf16 = 1:
// the tensor-core kernel); d in {32, 64, 128}; hq a multiple of hkv; s a
// multiple of min(128, s). scale: 1/sqrt(d) rounded to f32.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int hq, int hkv, int s, int d,
                           int bf16, float scale, cudaStream_t stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || s < 1 ||
      s % (s < kMaxBlockK ? s : kMaxBlockK) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, b, hq, hkv, s, bf16, scale, stream);
    case 64: return launch<64>(q, k, v, o, b, hq, hkv, s, bf16, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, b, hq, hkv, s, bf16, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
