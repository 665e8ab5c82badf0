// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the 64-row tiling, the visibility mask, and the bf16 tensor-core helpers
// (ldmatrix loads, mma.sync m16n8k16, bf16 packing, tile loads into padded
// shared memory). Everything here sits in an anonymous namespace: each .cu
// is its own library with a plain C interface.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // key rows per tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ bool visible(int mode, int qg, int kg, int S) {
  return kg < S && (mode == 0 || (mode == 1 ? qg >= kg : qg > kg));
}

// Threads of a bf16 tensor-core block: 4 warps of 16 rows each.
constexpr int kMmaThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b for one 16x8 tile: a is 16x16 (row), b is 16x8 (col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of one head into a padded [64][DP + 8] bf16 tile,
// 16 bytes at a time when `vec` (every row start 16-byte aligned,
// D % 8 == 0); rows past S and columns past D are zero.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               long long ss, int row0, int S,
                                               int D, bool vec) {
  constexpr int P = DP + 8, C = DP / 8;
  for (int c = threadIdx.x; c < kBK * C; c += kMmaThreads) {
    const int r = c / C, d0 = (c % C) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S && d0 < D) {
      const bf16* g = src + row * ss + d0;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(g);
      } else {
        alignas(16) bf16 tmp[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          tmp[e] = d0 + e < D ? g[e] : __float2bfloat16(0.f);
        val = *reinterpret_cast<const uint4*>(tmp);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * P + d0) = val;
  }
}

// Every [B, S, H] row start of a tensor 16-byte aligned (the vector loads).
inline bool aligned16(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

}  // namespace
