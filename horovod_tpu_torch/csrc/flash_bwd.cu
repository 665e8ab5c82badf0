// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by horovod_tpu_torch/_build.py).
//
// Replaces: horovod_tpu/ops/pallas_attention.py::_bwd_dq_kernel (B2) and
// ::_bwd_dkv_kernel (B3), launched by _call_bwd. Same function, the
// FlashAttention-2 backward that recomputes P per tile:
//   P  = exp(S - LSE) with S = (Q K^T) * scale, set to 0 where the mask is
//        false (selected, never multiplied: a fully masked row has
//        LSE = -1e30, so exp(S - LSE) is +inf there and inf * 0 is NaN);
//   dP = dO V^T,  dS = P * (dP - delta);
//   B2: dQ = scale * sum_k dS K                    (one block per Q tile)
//   B3: dV = sum_q P^T dO, dK = scale * sum_q dS^T Q (one block per K tile)
// delta = rowsum(dO * O) - dLSE comes in precomputed (float32 [B, H, S]).
// Each output row is summed inside one block, so there is no atomic and the
// result is deterministic, as in the reference.
//
// Layout: q, k, v, dO are [B, S, H, D] with any strides whose last one is
// 1; LSE and delta are contiguous [B, H, S] float32; dQ, dK, dV are written
// contiguous [B, S, H, D]. D <= 128 (tiles are zero-padded to 64 or 128),
// any S: keys past S contribute nothing and queries past S write nothing,
// in every mode (the reference refuses such an S; the port masks it).
//
// What bounds it on an H100: at the training width (B=8, S=512, H=16,
// D=64, causal) B2 moves ~42.5 MB (Q, K, V, dO, LSE, delta read, dQ
// written) against 6.5 GFLOP (3 products of 2*D flops per live pair) and
// B3 ~50.9 MB against 8.6 GFLOP (4 products), so memory bounds both there
// (~13 and ~15 us at 3.35 TB/s); at S=4096 the causal work grows 8x and the
// bf16 tensor-core rate bounds them (~52 and ~70 us at 989 TFLOP/s).
//
// What the design does about it: a block reads its own tile once and each
// tile it streams once from device memory into shared memory, and keeps
// S, P, dP and dS out of device memory entirely. Three variants of each
// kernel; the caller picks one (ops/flash_attention.py _bwd_variant) and
// names it in the entry point's `variant`:
//   - tma, bf16 with D % 8 == 0 and every row of q, k, v and dO 16-byte
//     aligned with positive strides, which is every call of the training
//     paths: TMA, mbarriers and wgmma, warp-specialised, the mirror of
//     flash_fwd.cu's flash_fwd_tma_kernel (helpers in hopper.cuh). A
//     producer warpgroup streams the other side's tiles through a ring;
//     one consumer warpgroup of 64 rows computes both score products
//     (S and dP) with wgmma from shared memory and the output products with
//     P and dS as register operands, so no fragment is re-read from
//     shared memory by a thread. Two blocks share an SM and run out of
//     step, so one's exponentials can overlap the other's products.
//   - mma, any other bf16: tensor cores through mma.sync m16n8k16 (bf16
//     in, f32 accumulate), 4 warps of 16 rows each, with B1's fragment
//     layout, synchronous loads (the first kernels).
//   - fma, float32: FMAs on float32 shared-memory tiles, never rounded.
// The bf16 variants round P and dS to bf16 for the P^T dO, dS K and
// dS^T Q products; every accumulator stays float32.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: 256 threads as a 16 x 16 grid (tx = tid % 16, ty = tid / 16). A
// thread owns rows ty + 16 i (i < 4) and columns tx + 16 j (j < 4) of each
// 64 x 64 score tile, and output columns tx + 16 c (c < DP / 16) of its
// rows. Tiles are [64][DP + 1] floats: the odd pitch spreads the 16 rows a
// half warp reads at one column over 16 banks.

constexpr int kFmaThreads = 256;
constexpr int kPs = kBK + 1;            // pitch of the [64][64] P / dS tiles

// Rows [row0, row0 + 64) of one head into dst [64][DP + 1], times `mul`;
// rows past S and columns past D are zero.
template <int DP>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ss, int row0, int S,
                                              int D, float mul) {
  constexpr int P = DP + 1;
  for (int e = threadIdx.x; e < kBK * DP; e += blockDim.x) {
    const int r = e / DP, d = e % DP;
    const int row = row0 + r;
    dst[r * P + d] = row < S && d < D ? src[row * ss + d] * mul : 0.f;
  }
}

// LSE or delta of rows [row0, row0 + 64) of one head; 0 past S.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int S) {
  for (int r = threadIdx.x; r < kBQ; r += blockDim.x)
    dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
}

// B2, float32. Shared: sQ (Q * scale), sO (dO), sK, sV, each [64][DP + 1];
// sDS [64 q][65]; sL, sD [64] (LSE, delta of the block's rows).
template <int DP>
constexpr int dq_f32_smem_bytes() {
  return 4 * (4 * kBQ * (DP + 1) + kBQ * kPs + 2 * kBQ);
}

template <int DP>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        Strides qs, Strides ks, Strides vs, Strides os, int H,
                        int S, int D, float sm_scale, int mode) {
  constexpr int P = DP + 1, CPT = DP / 16;
  extern __shared__ float4 smem_f32[];
  float* sQ = reinterpret_cast<float*>(smem_f32);
  float* sO = sQ + kBQ * P;
  float* sK = sO + kBQ * P;
  float* sV = sK + kBK * P;
  float* sDS = sV + kBK * P;
  float* sL = sDS + kBQ * kPs;
  float* sD = sL + kBQ;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heavy causal tiles first
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows_f32<DP>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S, D, sm_scale);
  load_rows_f32<DP>(sO, dout + b * os.b + h * os.h, os.s, q0, S, D, 1.f);
  load_vec(sL, lse + static_cast<long long>(bh) * S, q0, S);
  load_vec(sD, delta + static_cast<long long>(bh) * S, q0, S);
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  // Causal frontier: kBQ == kBK, so the last key tile is the diagonal one.
  const int kt_end = mode == 0 ? (S + kBK - 1) / kBK : qt + 1;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's sK / sV / sDS reads are done
    load_rows_f32<DP>(sK, kh, ks.s, k0, S, D, 1.f);
    load_rows_f32<DP>(sV, vh, vs.s, k0, S, D, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], o[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty + 16 * i) * P + d];
        o[i] = sO[(ty + 16 * i) * P + d];
        kk[i] = sK[(tx + 16 * i) * P + d];
        vv[i] = sV[(tx + 16 * i) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qg = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool keep = qg < S && visible(mode, qg, k0 + c, S);
        const float p = keep ? expf(s[i][j] - sL[r]) : 0.f;
        sDS[r * kPs + c] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sDS[(ty + 16 * i) * kPs + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float kv = sK[c * P + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(ds[i], kv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + ty + 16 * i;
    if (qg >= S) continue;
    float* row = dq + ((static_cast<long long>(b) * S + qg) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) row[d] = acc[i][cc] * sm_scale;
    }
  }
}

// B3, float32. Shared: sK, sV (the block's keys), sQ (Q * scale), sO (dO),
// each [64][DP + 1]; sP, sDS [64 k][65]; sL, sD [64] (LSE, delta of the
// current Q tile).
template <int DP>
constexpr int dkv_f32_smem_bytes() {
  return 4 * (4 * kBQ * (DP + 1) + 2 * kBK * kPs + 2 * kBQ);
}

template <int DP>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Strides qs, Strides ks, Strides vs, Strides os, int H,
                         int S, int D, float sm_scale, int mode) {
  constexpr int P = DP + 1, CPT = DP / 16;
  extern __shared__ float4 smem_f32[];
  float* sK = reinterpret_cast<float*>(smem_f32);
  float* sV = sK + kBK * P;
  float* sQ = sV + kBK * P;
  float* sO = sQ + kBQ * P;
  float* sP = sO + kBQ * P;
  float* sDS = sP + kBK * kPs;
  float* sL = sDS + kBK * kPs;
  float* sD = sL + kBQ;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kt = blockIdx.y;  // heavy causal tiles (low kt) first
  const int k0 = kt * kBK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows_f32<DP>(sK, k + b * ks.b + h * ks.h, ks.s, k0, S, D, 1.f);
  load_rows_f32<DP>(sV, v + b * vs.b + h * vs.h, vs.s, k0, S, D, 1.f);
  const float* qh = q + b * qs.b + h * qs.h;
  const float* oh = dout + b * os.b + h * os.h;
  const float* lh = lse + static_cast<long long>(bh) * S;
  const float* dh = delta + static_cast<long long>(bh) * S;

  float acc_k[4][CPT], acc_v[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // Causal frontier: Q tiles before the diagonal one see none of our keys.
  const int nq = (S + kBQ - 1) / kBQ;
  for (int qt = mode == 0 ? 0 : kt; qt < nq; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // previous tile's sQ / sO / sP / sDS reads are done
    load_rows_f32<DP>(sQ, qh, qs.s, q0, S, D, sm_scale);
    load_rows_f32<DP>(sO, oh, os.s, q0, S, D, 1.f);
    load_vec(sL, lh, q0, S);
    load_vec(sD, dh, q0, S);
    __syncthreads();

    // Transposed scores: rows are our keys, columns the tile's queries.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float kk[4], vv[4], a[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = sK[(ty + 16 * i) * P + d];
        vv[i] = sV[(ty + 16 * i) * P + d];
        a[i] = sQ[(tx + 16 * i) * P + d];
        o[i] = sO[(tx + 16 * i) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(kk[i], a[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], o[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, kg = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, qg = q0 + c;
        const bool keep = qg < S && visible(mode, qg, kg, S);
        const float p = keep ? expf(st[i][j] - sL[c]) : 0.f;
        sP[r * kPs + c] = p;
        sDS[r * kPs + c] = p * (dpt[i][j] - sD[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBQ; ++c) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = sP[(ty + 16 * i) * kPs + c];
        ds[i] = sDS[(ty + 16 * i) * kPs + c];
      }
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float ov = sO[c * P + tx + 16 * cc];
        const float qv = sQ[c * P + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][cc] = fmaf(p[i], ov, acc_v[i][cc]);
          acc_k[i][cc] = fmaf(ds[i], qv, acc_k[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kg = k0 + ty + 16 * i;
    if (kg >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + kg) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) {
        dk[off + d] = acc_k[i][cc];   // sQ carries the scale
        dv[off + d] = acc_v[i][cc];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync.m16n8k16, 4 warps; warp w owns
// rows w*16 .. w*16+15 of the block's own tile (queries in B2, keys in B3).
// In the m16n8 accumulator layout a thread holds rows g = lane/4 and g+8
// and columns 2t, 2t+1 (t = lane%4) of each 8-wide tile. Shared tiles are
// [64][DP + 8] bf16 (the 16-byte pad puts an ldmatrix's 8 rows in 8 bank
// groups). Operands, with X any of the [64][DP] tiles:
//   A = rows of the warp's own tile:          ldmatrix   (as B1's Q)
//   B = X^T for a product over D (S, dP):     ldmatrix   (as B1's K)
//   B = X   for a product over the 64 rows:   ldmatrix.trans (as B1's V)

// A fragment (16 rows x 16 of D at column kd) of the warp's rows of `x`.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* x, int P,
                                       int kd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ldmatrix_x4(r, x + (warp * 16 + (lane & 15)) * P + kd + (lane >> 4) * 8);
}

// B fragments of rows np*16 .. np*16+15 of `x`, D columns kd .. kd+15:
// r[0], r[1] for the 8-wide tile 2*np, r[2], r[3] for tile 2*np + 1.
__device__ __forceinline__ void load_b_rows(uint32_t (&r)[4], const bf16* x,
                                            int P, int np, int kd) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(r, x + (np * 16 + (lane & 7) + (lane >> 4) * 8) * P + kd +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of rows j*16 .. j*16+15 of `x` as the contraction, D columns
// op*16 .. op*16+15: r[0], r[1] for output tile 2*op, r[2], r[3] for 2*op+1.
__device__ __forceinline__ void load_b_trans(uint32_t (&r)[4], const bf16* x,
                                             int P, int j, int op) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(r, x + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                           op * 16 + (lane >> 4) * 8);
}

// x[2j], x[2j+1] (accumulators of 16 adjacent columns) as an A operand.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], float (*x)[4],
                                       int j) {
  a[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
  a[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
  a[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
  a[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
}

// acc (16 x DP) += a (16 x 16) * rows j*16 .. j*16+15 of x.
template <int DP>
__device__ __forceinline__ void mma_rows(float (*acc)[4],
                                         const uint32_t (&a)[4], const bf16* x,
                                         int j) {
  constexpr int P = DP + 8;
#pragma unroll
  for (int op = 0; op < DP / 16; ++op) {
    uint32_t bx[4];
    load_b_trans(bx, x, P, j, op);
    mma_bf16(acc[2 * op], a, bx[0], bx[1]);
    mma_bf16(acc[2 * op + 1], a, bx[2], bx[3]);
  }
}

// s = A Bt^T and dp = A2 Bt2^T over D, for the warp's 16 rows x 64 columns:
// (A, Bt, A2, Bt2) = (Q, K, dO, V) in B2 and (K, Q, V, dO) in B3.
template <int DP>
__device__ __forceinline__ void two_scores(float (&s)[8][4], float (&dp)[8][4],
                                           const bf16* A, const bf16* Bt,
                                           const bf16* A2, const bf16* Bt2) {
  constexpr int P = DP + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DP; kd += 16) {
    uint32_t a[4], a2[4];
    load_a(a, A, P, kd);
    load_a(a2, A2, P, kd);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bt[4], bt2[4];
      load_b_rows(bt, Bt, P, np, kd);
      mma_bf16(s[2 * np], a, bt[0], bt[1]);
      mma_bf16(s[2 * np + 1], a, bt[2], bt[3]);
      load_b_rows(bt2, Bt2, P, np, kd);
      mma_bf16(dp[2 * np], a2, bt2[0], bt2[1]);
      mma_bf16(dp[2 * np + 1], a2, bt2[2], bt2[3]);
    }
  }
}

template <int DP>
constexpr int mma_smem_bytes() {
  return 4 * kBQ * (DP + 8) * 2 + 2 * kBQ * 4;
}

// B2, bf16. Shared: sQ, sO (dO), sK, sV.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, Strides qs, Strides ks,
                         Strides vs, Strides os, int H, int S, int D,
                         float sm_scale, int mode, int vec) {
  constexpr int P = DP + 8, OT = DP / 8;
  extern __shared__ uint4 smem_bf16[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_bf16);
  bf16* sO = sQ + kBQ * P;
  bf16* sK = sO + kBQ * P;
  bf16* sV = sK + kBK * P;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heavy causal tiles first
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile_bf16<DP>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S, D, vec);
  load_tile_bf16<DP>(sO, dout + b * os.b + h * os.h, os.s, q0, S, D, vec);
  const bf16* kh = k + b * ks.b + h * ks.h;
  const bf16* vh = v + b * vs.b + h * vs.h;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qg = q0 + warp * 16 + g + r * 8;
    const long long i = static_cast<long long>(bh) * S + qg;
    lse_r[r] = qg < S ? lse[i] : 0.f;
    del_r[r] = qg < S ? delta[i] : 0.f;
  }

  float acc[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[ot][c] = 0.f;

  const int kt_end = mode == 0 ? (S + kBK - 1) / kBK : qt + 1;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's sK / sV reads are done
    load_tile_bf16<DP>(sK, kh, ks.s, k0, S, D, vec);
    load_tile_bf16<DP>(sV, vh, vs.s, k0, S, D, vec);
    __syncthreads();

    float s[8][4], dp[8][4];
    two_scores<DP>(s, dp, sQ, sK, sO, sV);
    // s becomes dS = P * (dP - delta) in place.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qg = q0 + warp * 16 + g + r * 8;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = r * 2 + c;
          const bool keep =
              qg < S && visible(mode, qg, k0 + nt * 8 + 2 * t + c, S);
          const float p = keep ? expf(s[nt][e] * sm_scale - lse_r[r]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - del_r[r]);
        }
    }
    // dQ += dS K, 16 keys per step.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t a[4];
      pack_a(a, s, j);
      mma_rows<DP>(acc, a, sK, j);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qg = q0 + warp * 16 + g + r * 8;
    if (qg >= S) continue;
    bf16* row = dq + ((static_cast<long long>(b) * S + qg) * H + h) * D;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = ot * 8 + 2 * t + c;
        if (d < D) row[d] = __float2bfloat16(acc[ot][r * 2 + c] * sm_scale);
      }
  }
}

// B3, bf16. Shared: sK, sV (the block's keys), sQ, sO (dO), then sL, sD
// (LSE, delta of the current Q tile, float32).
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          Strides qs, Strides ks, Strides vs, Strides os,
                          int H, int S, int D, float sm_scale, int mode,
                          int vec) {
  constexpr int P = DP + 8, OT = DP / 8;
  extern __shared__ uint4 smem_bf16[];
  bf16* sK = reinterpret_cast<bf16*>(smem_bf16);
  bf16* sV = sK + kBK * P;
  bf16* sQ = sV + kBK * P;
  bf16* sO = sQ + kBQ * P;
  float* sL = reinterpret_cast<float*>(sO + kBQ * P);
  float* sD = sL + kBQ;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kt = blockIdx.y;  // heavy causal tiles (low kt) first
  const int k0 = kt * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile_bf16<DP>(sK, k + b * ks.b + h * ks.h, ks.s, k0, S, D, vec);
  load_tile_bf16<DP>(sV, v + b * vs.b + h * vs.h, vs.s, k0, S, D, vec);
  const bf16* qh = q + b * qs.b + h * qs.h;
  const bf16* oh = dout + b * os.b + h * os.h;
  const float* lh = lse + static_cast<long long>(bh) * S;
  const float* dh = delta + static_cast<long long>(bh) * S;

  float acc_k[OT][4], acc_v[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[ot][c] = acc_v[ot][c] = 0.f;

  // Causal frontier: Q tiles before the diagonal one see none of our keys.
  const int nq = (S + kBQ - 1) / kBQ;
  for (int qt = mode == 0 ? 0 : kt; qt < nq; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // previous tile's sQ / sO / sL / sD reads are done
    load_tile_bf16<DP>(sQ, qh, qs.s, q0, S, D, vec);
    load_tile_bf16<DP>(sO, oh, os.s, q0, S, D, vec);
    load_vec(sL, lh, q0, S);
    load_vec(sD, dh, q0, S);
    __syncthreads();

    // Transposed: rows are our keys, columns the tile's queries. st
    // becomes P^T and dpt becomes dS^T in place.
    float st[8][4], dpt[8][4];
    two_scores<DP>(st, dpt, sK, sQ, sV, sO);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kg = k0 + warp * 16 + g + r * 8;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = r * 2 + c, j = nt * 8 + 2 * t + c, qg = q0 + j;
          const bool keep = qg < S && visible(mode, qg, kg, S);
          const float p = keep ? expf(st[nt][e] * sm_scale - sL[j]) : 0.f;
          dpt[nt][e] = p * (dpt[nt][e] - sD[j]);
          st[nt][e] = p;
        }
    }
    // dV += P^T dO and dK += dS^T Q, 16 queries per step.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t a[4];
      pack_a(a, st, j);
      mma_rows<DP>(acc_v, a, sO, j);
      pack_a(a, dpt, j);
      mma_rows<DP>(acc_k, a, sQ, j);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kg = k0 + warp * 16 + g + r * 8;
    if (kg >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + kg) * H + h) * D;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = ot * 8 + 2 * t + c;
        if (d < D) {
          dk[off + d] = __float2bfloat16(acc_k[ot][r * 2 + c] * sm_scale);
          dv[off + d] = __float2bfloat16(acc_v[ot][r * 2 + c]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on Hopper: TMA ring, mbarriers and wgmma, warp-specialised.
//
// One block per (b*h, 64-row tile of its own side: queries in B2, keys in
// B3): one consumer warpgroup, then one producer warpgroup.
//   - The producer: one thread loads the block's own two tiles once (Q and
//     dO in B2, K and V in B3), then each tile of the other side into a
//     ring of kBwdStages stages, waiting on a stage's "empty" barrier
//     before reusing it; each load completes on a "full" barrier. In B2,
//     K and V have a barrier each both ways, as in the forward. In B3, Q
//     and dO complete apart and free together, and a second warp of the
//     producer copies the tile's LSE (times log2 e) and delta into the
//     stage with plain loads (0 past S) and arrives on the stage's third
//     "full" barrier.
//   - The consumer, per streamed tile of 64 rows: the two score products
//     over D by wgmma m64n64k16 with both operands K-major in shared
//     memory (B2: S = Q K^T and dP = dO V^T; B3: S^T = K Q^T and
//     dP^T = V dO^T), each its own commit group, so P = exp2(S * scale *
//     log2 e - LSE * log2 e) starts while dP is still in flight; where a
//     row's integer limit excludes a score, P is selected to 0; dS = P (dP
//     - delta); P and dS packed to bf16 in place as register A operands of
//     the output products (wgmma m64nDPk16, the B operand the streamed or
//     own tile read MN-major): B2 dQ += dS K; B3 dV += P^T dO and
//     dK += dS^T Q. B3's two output products stay in flight while the
//     next tile's score products are issued (its stage is freed one tile
//     later); B2 waits on its one, which measured faster there.
// Tiles are [64][DP] bf16 in 64-column atoms, 128-byte swizzled
// (hopper.cuh): TMA writes them so and the descriptors read them so. Rows
// past S and columns past D arrive as zeros. The epilogue writes the
// output through the block's own tiles (no longer read), swizzled as they
// are, so that each row leaves in 16-byte stores.

constexpr int kBwdRows = 64;                 // rows of every tile
constexpr int kBwdStages = 2;
constexpr int kBwdAtom = kBwdRows * 128;     // 64 rows x 64 bf16 columns

// A block's shape: 256 threads, two blocks an SM. The launch bound gives
// 128 registers a thread at entry; setmaxnreg moves the producer's spare
// ones to the consumer.
template <int DP>
struct BwdTmaShape {
  static constexpr int kThreads = 256;
  static constexpr int kBlocksPerSM = 2;
  static constexpr int kTile = kBwdAtom * (DP / 64);  // one [64][DP] tile
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kBarriers = 8 * (1 + 4 * kBwdStages);
  // B2: Q, dO, then K and V of each stage. B3: K, V, then Q and dO of each
  // stage, then LSE and delta (64 floats each) of each stage. Then the
  // barriers, plus 1 KB so the tiles can start on a 1024-byte boundary.
  static constexpr int kDqSmem =
      2 * kTile + 2 * kBwdStages * kTile + kBarriers + 1024;
  static constexpr int kDkvSmem = 2 * kTile + 2 * kBwdStages * kTile +
                                  2 * kBwdStages * kBwdRows * 4 + kBarriers +
                                  1024;
};

// d = A B^T over D, A and B [64][DP] tiles (K-major), as wgmma
// m64n64k16 steps of 16 columns (32 bytes along a row).
template <int DP>
__device__ __forceinline__ void mma_over_d(float (&d)[32], const uint8_t* a,
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk / 4) * kBwdAtom + (kk % 4) * 32;
    wgmma_ss_n64(d, sw128_desc(a + off, 16, 1024),
                 sw128_desc(b + off, 16, 1024), kk);
  }
}

// d (64 x DP) += A (64 x 64, in registers) * X, X a [64][DP] tile whose 64
// rows are the reduction (read MN-major), 16 rows a step.
template <int DP>
__device__ __forceinline__ void mma_over_rows(float (&d)[DP / 2],
                                              const uint32_t (&a)[16],
                                              const uint8_t* x) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
    wgmma_rs(d, a[4 * kb], a[4 * kb + 1], a[4 * kb + 2], a[4 * kb + 3],
             sw128_desc(x + kb * 16 * 128, kBwdAtom, 1024));
}

// The accumulators of a 64 x 64 product, in bf16, as the register A
// operand of a product over its 64 columns: columns 16 kb .. 16 kb + 15
// are the m16n8k16 A fragment made of the accumulators of columns 16 kb
// and 16 kb + 8, so a[j] packs x[2 j] and x[2 j + 1].
__device__ __forceinline__ void pack_frags(uint32_t (&a)[16],
                                           const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = pack_bf16(x[2 * j], x[2 * j + 1]);
}

// B2, bf16 on TMA and wgmma: dQ of 64 query rows.
template <int DP>
__global__ void __launch_bounds__(BwdTmaShape<DP>::kThreads,
                                  BwdTmaShape<DP>::kBlocksPerSM)
flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int S, int D,
                        float scale_log2, float sm_scale, int mode) {
  using Sh = BwdTmaShape<DP>;
  constexpr int kTile = Sh::kTile;
  extern __shared__ uint8_t smem_bwd[];
  uint8_t* smem = align1024(smem_bwd);
  uint8_t* sQ = smem;
  uint8_t* sO = smem + kTile;
  uint8_t* kv = smem + 2 * kTile;  // stage st: K at 2 st, V at 2 st + 1
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(kv + 2 * kBwdStages * kTile);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kBwdStages;
  uint64_t* k_empty = v_full + kBwdStages;
  uint64_t* v_empty = k_empty + kBwdStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // Heavy causal tiles first; causal frontier: the key tile of the
  // block's last row (a key tile has as many rows as a query tile).
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kBwdRows;
  const int n_tiles = mode == 0 ? (S + kBwdRows - 1) / kBwdRows : qt + 1;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], 128);
      mbar_init(&v_empty[st], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 1) {
    // Producer. The roles never meet again: no block-wide barrier below.
    setmaxnreg_dec<Sh::kProducerRegs>();
    if (threadIdx.x == 128) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      mbar_expect_tx(q_full, 2 * kTile);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        tma_load_4d(sQ + c * kBwdAtom, &tq, q_full, 64 * c, q0, h, b);
        tma_load_4d(sO + c * kBwdAtom, &tdo, q_full, 64 * c, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kBwdStages;
        const uint32_t vacant = ((j / kBwdStages) & 1) ^ 1;
        uint8_t* sK = kv + kTile * 2 * st;
        mbar_wait(&k_empty[st], vacant);
        mbar_expect_tx(&k_full[st], kTile);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          tma_load_4d(sK + c * kBwdAtom, &tk, &k_full[st], 64 * c,
                      j * kBwdRows, h, b);
        mbar_wait(&v_empty[st], vacant);
        mbar_expect_tx(&v_full[st], kTile);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          tma_load_4d(sK + kTile + c * kBwdAtom, &tv, &v_full[st], 64 * c,
                      j * kBwdRows, h, b);
      }
    }
  } else {
    setmaxnreg_inc<Sh::kConsumerRegs>();
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // This thread's rows q0 + 16 warp + g + 8 r: LSE in log2 units and
    // delta (0 past S), and the number of keys of the tile visible to
    // the row past column 2 t (keys [0, lim) are visible to row qg).
    float lse2[2], dlt[2];
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qg = q0 + 16 * warp + g + 8 * r;
      const long long i = static_cast<long long>(bh) * S + qg;
      lse2[r] = qg < S ? lse[i] * kLog2e : 0.f;
      dlt[r] = qg < S ? delta[i] : 0.f;
      lim[r] = mode == 0 ? S : min(S, mode == 1 ? qg + 1 : qg);
    }
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kBwdStages;
      const uint32_t parity = (j / kBwdStages) & 1;
      const uint8_t* sK = kv + kTile * 2 * st;
      const uint8_t* sV = sK + kTile;
      const int k0 = j * kBwdRows;

      float s[32], dp[32];
      mbar_wait(&k_full[st], parity);
      wgmma_fence();
      mma_over_d<DP>(s, sQ, sK);
      wgmma_commit();
      mbar_wait(&v_full[st], parity);
      mma_over_d<DP>(dp, sO, sV);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P in place of S; s[4 nb + 2 r + c] is key k0 + 8 nb + 2 t + c.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rem = lim[r] - k0 - 2 * t;  // visible: 8 nb + c < rem
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[4 * nb + 2 * r + c];
            const float p = exp2_approx(fmaf(x, scale_log2, -lse2[r]));
            x = 8 * nb + c < rem ? p : 0.f;  // selected: p may be inf
          }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      mbar_arrive(&v_empty[st]);

      // dS = P (dP - delta) as the A operand of dQ += dS K.
      uint32_t ds[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        ds[i] = pack_bf16(s[2 * i] * (dp[2 * i] - dlt[i % 2]),
                          s[2 * i + 1] * (dp[2 * i + 1] - dlt[i % 2]));
      fence_regs(ds);
      fence_regs(acc);
      wgmma_fence();
      mma_over_rows<DP>(acc, ds, sK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ds);
      mbar_arrive(&k_empty[st]);
    }
    store_acc_rows<DP>(acc, {sm_scale, sm_scale}, sQ, kBwdAtom, 1, dq, b, h,
                       H, S, D, q0);
  }
}

// B3, bf16 on TMA and wgmma: dK and dV of 64 key rows.
template <int DP>
__global__ void __launch_bounds__(BwdTmaShape<DP>::kThreads,
                                  BwdTmaShape<DP>::kBlocksPerSM)
flash_bwd_dkv_tma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int S, int D, float scale_log2, float sm_scale,
                         int mode) {
  using Sh = BwdTmaShape<DP>;
  constexpr int kTile = Sh::kTile;
  extern __shared__ uint8_t smem_bwd[];
  uint8_t* smem = align1024(smem_bwd);
  uint8_t* sK = smem;
  uint8_t* sV = smem + kTile;
  uint8_t* qo = smem + 2 * kTile;  // stage st: Q at 2 st, dO at 2 st + 1
  // stage st: LSE * log2 e at 2 st, delta at 2 st + 1 (64 floats each)
  float* ld = reinterpret_cast<float*>(qo + 2 * kBwdStages * kTile);
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(ld + 2 * kBwdStages * kBwdRows);
  uint64_t* q_full = kv_full + 1;
  uint64_t* o_full = q_full + kBwdStages;
  uint64_t* l_full = o_full + kBwdStages;
  uint64_t* empty = l_full + kBwdStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // Heavy causal tiles (low key tiles) first; causal frontier: query
  // tiles before the diagonal one see none of the block's keys.
  const int kt = blockIdx.y;
  const int k0 = kt * kBwdRows;
  const int j0 = mode == 0 ? 0 : kt;
  const int n_tiles = (S + kBwdRows - 1) / kBwdRows - j0;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(&q_full[st], 1);
      mbar_init(&o_full[st], 1);
      mbar_init(&l_full[st], 32);
      mbar_init(&empty[st], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 1) {
    // Producer: warp 0 issues the TMA loads, warp 1 copies LSE and delta.
    setmaxnreg_dec<Sh::kProducerRegs>();
    const int ptid = threadIdx.x - 128;
    if (ptid == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      mbar_expect_tx(kv_full, 2 * kTile);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        tma_load_4d(sK + c * kBwdAtom, &tk, kv_full, 64 * c, k0, h, b);
        tma_load_4d(sV + c * kBwdAtom, &tv, kv_full, 64 * c, k0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kBwdStages;
        const uint32_t vacant = ((j / kBwdStages) & 1) ^ 1;
        const int q0 = (j0 + j) * kBwdRows;
        uint8_t* sQ = qo + kTile * 2 * st;
        mbar_wait(&empty[st], vacant);
        mbar_expect_tx(&q_full[st], kTile);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          tma_load_4d(sQ + c * kBwdAtom, &tq, &q_full[st], 64 * c, q0, h, b);
        mbar_expect_tx(&o_full[st], kTile);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          tma_load_4d(sQ + kTile + c * kBwdAtom, &tdo, &o_full[st], 64 * c,
                      q0, h, b);
      }
    } else if (ptid / 32 == 1) {
      const int lane = ptid % 32;
      const float* lh = lse + static_cast<long long>(bh) * S;
      const float* dh = delta + static_cast<long long>(bh) * S;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kBwdStages;
        const uint32_t vacant = ((j / kBwdStages) & 1) ^ 1;
        const int q0 = (j0 + j) * kBwdRows;
        float* sl = ld + 2 * st * kBwdRows;
        mbar_wait(&empty[st], vacant);
#pragma unroll
        for (int e = lane; e < kBwdRows; e += 32) {
          const int q = q0 + e;
          sl[e] = q < S ? lh[q] * kLog2e : 0.f;
          sl[kBwdRows + e] = q < S ? dh[q] : 0.f;
        }
        mbar_arrive(&l_full[st]);  // release: the stores above first
      }
    }
  } else {
    setmaxnreg_inc<Sh::kConsumerRegs>();
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // Queries [qlo, S) see key row k0 + 16 warp + g + 8 r (none past S):
    // one unsigned compare a score.
    int qlo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kg = k0 + 16 * warp + g + 8 * r;
      qlo[r] = kg >= S ? S : mode == 0 ? 0 : mode == 1 ? kg : kg + 1;
    }
    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    // dV += P^T dO and dK += dS^T Q of tile j stay in flight while tile
    // j + 1's score products are issued; the stage of tile j is freed
    // once they have completed.
    uint32_t pa[16], da[16];
    mbar_wait(kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kBwdStages;
      const uint32_t parity = (j / kBwdStages) & 1;
      const uint8_t* sQ = qo + kTile * 2 * st;
      const uint8_t* sO = sQ + kTile;
      const float* sl = ld + 2 * st * kBwdRows;
      const float* sd = sl + kBwdRows;
      const int q0 = (j0 + j) * kBwdRows;

      float s[32], dp[32];
      mbar_wait(&q_full[st], parity);
      wgmma_fence();
      mma_over_d<DP>(s, sK, sQ);
      wgmma_commit();
      mbar_wait(&o_full[st], parity);
      mma_over_d<DP>(dp, sV, sO);
      wgmma_commit();
      mbar_wait(&l_full[st], parity);
      wgmma_wait<1>();  // tile j - 1's output products and this S^T
      fence_regs(s);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      if (j > 0) mbar_arrive(&empty[(j - 1) % kBwdStages]);

      // P^T in place of S^T; s[4 nb + 2 r + c] is query q0 + 8 nb + 2 t + c.
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(sl + 8 * nb + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[4 * nb + 2 * r + c];
            const float p =
                exp2_approx(fmaf(x, scale_log2, -(c ? l2.y : l2.x)));
            const int q = q0 + 8 * nb + 2 * t + c;
            x = static_cast<unsigned>(q - qlo[r]) <
                        static_cast<unsigned>(S - qlo[r])
                    ? p
                    : 0.f;  // selected: p may be inf
          }
      }
      wgmma_wait<0>();
      fence_regs(dp);

      // dS^T = P^T (dP^T - delta) in place of dP^T.
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(sd + 8 * nb + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * nb + 2 * r + c;
            dp[e] = s[e] * (dp[e] - (c ? d2.y : d2.x));
          }
      }
      pack_frags(pa, s);
      pack_frags(da, dp);
      fence_regs(pa);
      fence_regs(da);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
      mma_over_rows<DP>(dv_acc, pa, sO);
      mma_over_rows<DP>(dk_acc, da, sQ);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(da);
    store_acc_rows<DP>(dk_acc, {sm_scale, sm_scale}, sK, kBwdAtom, 1, dk, b,
                       h, H, S, D, k0);
    store_acc_rows<DP>(dv_acc, {1.f, 1.f}, sV, kBwdAtom, 1, dv, b, h, H, S, D,
                       k0);
  }
}

// ---------------------------------------------------------------------------
// Launchers: one template instance per padded head dim (64 or 128).

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, S, H, D;
  Strides qs, ks, vs, os;
  float sm_scale;
  int mode;
  cudaStream_t stream;
};

template <int DP>
int launch_dq(const Args& a, void* dq, int variant, int vec) {
  const dim3 grid(a.B * a.H, (a.S + kBQ - 1) / kBQ);
  if (variant == 0) {
    constexpr int bytes = dq_f32_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_f32_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_f32_kernel<DP><<<grid, kFmaThreads, bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(dq), a.qs, a.ks, a.vs, a.os, a.H,
        a.S, a.D, a.sm_scale, a.mode);
  } else {
    constexpr int bytes = mma_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_bf16_kernel<DP><<<grid, kMmaThreads, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.delta, static_cast<bf16*>(dq), a.qs, a.ks, a.vs, a.os, a.H,
        a.S, a.D, a.sm_scale, a.mode, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv(const Args& a, void* dk, void* dv, int variant, int vec) {
  const dim3 grid(a.B * a.H, (a.S + kBK - 1) / kBK);
  if (variant == 0) {
    constexpr int bytes = dkv_f32_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_f32_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_f32_kernel<DP><<<grid, kFmaThreads, bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv),
        a.qs, a.ks, a.vs, a.os, a.H, a.S, a.D, a.sm_scale, a.mode);
  } else {
    constexpr int bytes = mma_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_bf16_kernel<DP><<<grid, kMmaThreads, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.qs,
        a.ks, a.vs, a.os, a.H, a.S, a.D, a.sm_scale, a.mode, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tensor maps of q, k, v and dO for a tma launch (64-row boxes);
// 0, or -2 where cuTensorMapEncodeTiled refuses one.
int encode_maps(const Args& a, CUtensorMap (&m)[4]) {
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  const Strides* st[4] = {&a.qs, &a.ks, &a.vs, &a.os};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_bshd_bf16(&m[i], base[i], a.B, a.S, a.H, a.D,
                                     st[i]->b, st[i]->s, st[i]->h, kBwdRows);
    if (err != 0) return err;
  }
  return 0;
}

template <int DP>
int launch_dq_tma(const Args& a, void* dq) {
  using Sh = BwdTmaShape<DP>;
  CUtensorMap m[4];
  const int err = encode_maps(a, m);
  if (err != 0) return err;
  const cudaError_t cerr =
      set_dynamic_smem(flash_bwd_dq_tma_kernel<DP>, Sh::kDqSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  flash_bwd_dq_tma_kernel<DP>
      <<<dim3(a.B * a.H, (a.S + kBwdRows - 1) / kBwdRows), Sh::kThreads,
         Sh::kDqSmem, a.stream>>>(m[0], m[1], m[2], m[3], a.lse, a.delta,
                                  static_cast<bf16*>(dq), a.H, a.S, a.D,
                                  a.sm_scale * kLog2e, a.sm_scale, a.mode);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv_tma(const Args& a, void* dk, void* dv) {
  using Sh = BwdTmaShape<DP>;
  CUtensorMap m[4];
  const int err = encode_maps(a, m);
  if (err != 0) return err;
  const cudaError_t cerr =
      set_dynamic_smem(flash_bwd_dkv_tma_kernel<DP>, Sh::kDkvSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  flash_bwd_dkv_tma_kernel<DP>
      <<<dim3(a.B * a.H, (a.S + kBwdRows - 1) / kBwdRows), Sh::kThreads,
         Sh::kDkvSmem, a.stream>>>(m[0], m[1], m[2], m[3], a.lse, a.delta,
                                   static_cast<bf16*>(dk),
                                   static_cast<bf16*>(dv), a.H, a.S, a.D,
                                   a.sm_scale * kLog2e, a.sm_scale, a.mode);
  return static_cast<int>(cudaGetLastError());
}

// -1 for arguments the variant does not take, else 0 and `a` filled in.
// The tma variant also needs D % 8 == 0 and every [B, S, H] row of q, k,
// v and dO 16-byte aligned with positive strides (what a tensor map
// takes).
int make_args(Args& a, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              int variant, int B, int S, int H, int D, const long long* st,
              float sm_scale, int mode, void* stream, int* vec) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 128 || mode < 0 ||
      mode > 2 || variant < 0 || variant > 2 ||
      (S + kBQ - 1) / kBQ > 65535)
    return -1;
  a = Args{q, k, v, dout, lse, delta, B, S, H, D,
           Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
           Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
           sm_scale, mode, static_cast<cudaStream_t>(stream)};
  *vec = D % 8 == 0 && aligned16(q, a.qs) && aligned16(k, a.ks) &&
         aligned16(v, a.vs) && aligned16(dout, a.os);
  if (variant == 2) {
    bool positive = true;
    for (int i = 0; i < 12; ++i) positive = positive && st[i] > 0;
    if (!*vec || !positive) return -1;
  }
  return 0;
}

}  // namespace

extern "C" {

// variant: 0 = float32 (FMA), 1 = bfloat16 through mma.sync, 2 = bfloat16
// through TMA and wgmma (D % 8 == 0, every [B, S, H] row start 16-byte
// aligned, positive strides). mode: 0 none, 1 diag, 2 strict. Strides are
// in elements, for the B, S and H dims of each [B, S, H, D] input in the
// order q, k, v, dO (the D stride must be 1). Each returns a cudaError_t
// (0 = launched); -1 for arguments the variant does not take; -2 where
// cuTensorMapEncodeTiled refuses a tensor map.
int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, int variant, int B, int S, int H, int D,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long osb, long long oss, long long osh,
                     float sm_scale, int mode, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  Args a;
  int vec = 0;
  if (make_args(a, q, k, v, dout, lse, delta, variant, B, S, H, D, st,
                sm_scale, mode, stream, &vec) != 0)
    return -1;
  if (variant == 2)
    return D <= 64 ? launch_dq_tma<64>(a, dq) : launch_dq_tma<128>(a, dq);
  return D <= 64 ? launch_dq<64>(a, dq, variant, vec)
                 : launch_dq<128>(a, dq, variant, vec);
}

int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, int variant, int B, int S, int H,
                      int D, long long qsb, long long qss, long long qsh,
                      long long ksb, long long kss, long long ksh,
                      long long vsb, long long vss, long long vsh,
                      long long osb, long long oss, long long osh,
                      float sm_scale, int mode, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  Args a;
  int vec = 0;
  if (make_args(a, q, k, v, dout, lse, delta, variant, B, S, H, D, st,
                sm_scale, mode, stream, &vec) != 0)
    return -1;
  if (variant == 2)
    return D <= 64 ? launch_dkv_tma<64>(a, dk, dv)
                   : launch_dkv_tma<128>(a, dk, dv);
  return D <= 64 ? launch_dkv<64>(a, dk, dv, variant, vec)
                 : launch_dkv<128>(a, dk, dv, variant, vec);
}

const char* hvd_cuda_error_string(int err) {
  if (err == -1) return "argument not supported by the flash backward variant";
  if (err == -2) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
