// A probe of the tensor cores' q . k arithmetic, as the bf16 flash kernel
// runs it (csrc/flash_attention.cu): wgmma.m64n128k16.f32.bf16.bf16 with
// both operands K-major in shared memory, in the kernel's swizzled tile
// layout, chained over the head dimension in k16 steps from a zero
// accumulator.
//
// For each case (one 64 x D block of q rows and one 128 x D block of k
// rows, bf16, contiguous) and each chain length n = 1 .. D / 16, one
// warpgroup runs the first n k16 steps and writes the 64 x 128 f32
// accumulators: out[case][n - 1][row][col]. The host holds each step
// against exact sums (tools/wgmma_error_probe.py). Not a kernel of the
// port's paths: built on demand, never by build_all's default list.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;   // rows of a tile (the flash kernel's kTileRows)

template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;        // columns per atom
  static constexpr int kRowBytes = 2 * kCols;          // 64 or 128
  static constexpr int kSub = D / kCols;               // atoms across D
  static constexpr int kSubBytes = kRows * kRowBytes;
  static constexpr int kBytes = kSub * kSubBytes;      // one 128 x D tile
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The flash kernel's descriptor of a swizzled K-major tile.
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  constexpr uint64_t stride = (8 * Tile<D>::kRowBytes) >> 4;
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         (stride << 32) | (Tile<D>::kLayout << 62);
}

// Byte offset of row `row`, head dims 8 c8 .. 8 c8 + 7, in a swizzled tile.
template <int D>
__device__ __forceinline__ int chunk_offset(int row, int c8) {
  using L = Tile<D>;
  constexpr int kChunks = L::kCols / 8;
  const int sw = L::kRowBytes == 128 ? (row & 7) : ((row >> 1) & 3);
  return (c8 / kChunks) * L::kSubBytes + row * L::kRowBytes +
         (((c8 % kChunks) ^ sw) << 4);
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)

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

#undef F16
#undef F4

template <int D>
__global__ void __launch_bounds__(128)
    wgmma_probe_kernel(const uint4* q, const uint4* k, float* out) {
  using L = Tile<D>;
  extern __shared__ unsigned char raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + L::kBytes;
  const int c = blockIdx.x, t = threadIdx.x;
  constexpr int kChunks = D / 8;   // 16-byte chunks a row
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = t; i < kRows * kChunks; i += 128) {
    const int row = i / kChunks, c8 = i % kChunks;
    const int off = chunk_offset<D>(row, c8);
    *reinterpret_cast<uint4*>(Qs + off) =
        row < 64 ? q[((size_t)c * 64 + row) * kChunks + c8] : zero;
    *reinterpret_cast<uint4*>(Ks + off) =
        k[((size_t)c * kRows + row) * kChunks + c8];
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int lane = t % 32, rl = 16 * (t / 32) + lane / 4, c0 = 2 * (lane % 4);
  const uint32_t q_s = smem_u32(Qs), k_s = smem_u32(Ks);
  float s[64];
  for (int n = 1; n <= D / 16; ++n) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    for (int kk = 0; kk < n; ++kk) {
      const uint32_t off = (kk * 16 / L::kCols) * L::kSubBytes +
                           (kk * 16 % L::kCols) * 2;
      wgmma_qk(s, desc<D>(q_s + off), desc<D>(k_s + off), kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(s[i])::"memory");
    float* o = out + ((size_t)c * (D / 16) + n - 1) * 64 * kRows;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = 8 * (i / 4) + c0 + (i & 1);
      const int row = rl + 8 * ((i >> 1) & 1);
      o[row * kRows + col] = s[i];
    }
  }
}

template <int D>
int launch(const void* q, const void* k, float* out, int cases,
           cudaStream_t stream) {
  const int smem = 1024 + 2 * Tile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_probe_kernel<D><<<cases, 128, smem, stream>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(k), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [cases, 64, d] and k [cases, 128, d] bf16, contiguous, 16-byte
// aligned; out [cases, d / 16, 64, 128] f32; d in {32, 64, 128}.
int wgmma_probe_launch(const void* q, const void* k, float* out, int cases,
                       int d, cudaStream_t stream) {
  if (cases < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 32: return launch<32>(q, k, out, cases, stream);
    case 64: return launch<64>(q, k, out, cases, stream);
    case 128: return launch<128>(q, k, out, cases, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
