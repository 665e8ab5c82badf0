// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by horovod_tpu_torch/_build.py).
//
// Replaces: horovod_tpu/ops/pallas_attention.py::_fwd_kernel (launched by
// _call_fwd). Same function: S = (Q K^T) * scale, an online softmax with
// float32 running max m, sum l and accumulator, O = acc / l in the input
// dtype and LSE = m + log l in float32; modes none / diag (q >= k) /
// strict (q > k); key tiles past the causal diagonal are skipped; masked
// scores are set to -1e30 AND their probabilities zeroed explicitly (the
// sentinel is finite, so exp(s - max) on a fully masked row would be 1);
// rows with l == 0 emit O = 0 and LSE = -1e30.
//
// Layout: q, k, v are [B, S, H, D] with any strides whose last one is 1;
// O is written contiguous [B, S, H, D], LSE contiguous [B, H, S]. D <= 128
// (tiles are zero-padded to 64 or 128), any S (the ragged tail is masked).
//
// Three kernels; the caller picks one (ops/flash_attention.py
// _fwd_variant) and names it in hvd_flash_fwd's `variant`:
//   - tma, bf16 with D % 8 == 0 and 16-byte aligned rows, which is every
//     call of the serving and training paths: TMA, mbarriers and wgmma,
//     warp-specialised (flash_fwd_tma_kernel, helpers in hopper.cuh);
//   - mma, any other bf16: mma.sync m16n8k16 through ldmatrix, 4 warps
//     of 16 query rows, synchronous loads (flash_fwd_bf16_kernel);
//   - fma, float32: FMAs on float32 shared-memory tiles (no tensor
//     cores); it keeps f32 inputs exact, which the serving check needs.
//
// What bounds it on an H100: at the serving and training width (B=8,
// S=512, H=16, D=64, causal) the call moves ~34 MB (Q, K, V, O in bf16)
// against ~4.3 GFLOP, so the memory bound (~10 us at 3.35 TB/s) is above
// the bf16 tensor-core bound (~4.4 us); at S=4096 the causal work is 34
// GFLOP against 8.7 MB, and operations bound it (~35 us).
//
// What the tma design does about it: a block reads Q once and each K/V
// tile it needs once, by TMA, into a two-stage ring, so the next tile's
// loads run under this tile's products, and keeps S and P out of device
// memory. Both products run on wgmma, the only path to the full
// tensor-core rate: Q K^T with both operands in shared memory, P V with
// P in registers, so no warp re-reads fragments as mma.sync did. Key
// tiles of 128 do twice the work per byte loaded of the 64-key ones. At
// D <= 64 two blocks share an SM and run out of step, so one's softmax
// and start-up overlap the other's products. What still holds it back
// (PERF.md): within a warpgroup the softmax (exp2 on the SFUs) and the
// products take turns, and at D = 128 one block fills an SM.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: FMAs on shared-memory tiles. 256 threads as a 16 x 16 grid
// (tx = lane % 16, ty = tid / 16): a thread owns query rows ty*4..ty*4+3,
// score columns tx*4..tx*4+3 of each key tile and output columns
// tx*CPT..tx*CPT+CPT-1 (CPT = DP / 16). The 16 threads that share rows sit
// in one half warp, so row max and row sum are shuffles over xor 8..1.

constexpr int kFmaThreads = 256;
constexpr int kPitch = kBQ + 4;         // float pitch of the transposed tiles

// Shared memory, float32: sQ [DP][kPitch] (Q^T, pre-scaled), sK [DP][kPitch]
// (K^T), sV [kBK][DP], sP [kBK][kPitch] (P^T of the current score tile).
template <int DP>
constexpr int fma_smem_bytes() {
  return 4 * (2 * DP * kPitch + kBK * DP + kBK * kPitch);
}

template <int DP, bool kTranspose>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long ss, int row0, int S,
                                              int D, float mul) {
  for (int e = threadIdx.x; e < kBK * DP; e += kFmaThreads) {
    const int r = e / DP, d = e % DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < S && d < D) x = src[row * ss + d] * mul;
    if (kTranspose) {
      dst[d * kPitch + r] = x;
    } else {
      dst[r * DP + d] = x;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides qs, Strides ks,
                     Strides vs, int H, int S, int D, float sm_scale,
                     int mode) {
  constexpr int CPT = DP / 16;
  extern __shared__ float4 smem_f32[];
  float* sQ = reinterpret_cast<float*>(smem_f32);
  float* sK = sQ + DP * kPitch;
  float* sV = sK + DP * kPitch;
  float* sP = sV + kBK * DP;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heavy causal tiles first
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile_f32<DP, true>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S, D,
                          sm_scale);
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // Causal frontier: kBQ == kBK, so the last key tile is the diagonal one.
  const int kt_end = mode == 0 ? (S + kBK - 1) / kBK : qt + 1;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's sK / sV / sP reads are done
    load_tile_f32<DP, true>(sK, kh, ks.s, k0, S, D, 1.f);
    load_tile_f32<DP, false>(sV, vh, vs.s, k0, S, D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(sQ + d * kPitch + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(sK + d * kPitch + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qg = q0 + ty * 4 + i;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep[j] = visible(mode, qg, k0 + tx * 4 + j, S);
        if (!keep[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sP + (tx * 4 + j) * kPitch + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(sP + kk * kPitch + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float vv[CPT];
#pragma unroll
      for (int c4 = 0; c4 < CPT; c4 += 4) {
        const float4 w = *reinterpret_cast<const float4*>(sV + kk * DP + tx * CPT + c4);
        vv[c4] = w.x;
        vv[c4 + 1] = w.y;
        vv[c4 + 2] = w.z;
        vv[c4 + 3] = w.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(av[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + ty * 4 + i;
    if (qg >= S) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    float* orow = o + ((static_cast<long long>(b) * S + qg) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx * CPT + c;
      if (d < D) orow[d] = acc[i][c] / l_safe;
    }
    if (tx == 0)
      lse[static_cast<long long>(bh) * S + qg] =
          l[i] > 0.f ? m[i] + logf(l_safe) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync.m16n8k16 (bf16 x bf16 -> f32).
// 4 warps; warp w owns query rows w*16 .. w*16+15 of the block's tile. In
// the m16n8 accumulator layout a thread holds rows g = lane/4 and g+8 and
// columns 2t, 2t+1 (t = lane%4) of each 8-wide tile, so row max and row sum
// are shuffles over the 4 threads of a quad (xor 1, 2), and the score
// accumulators of two adjacent 8-key tiles are exactly the A operand of
// the next m16n8k16 product (P.V) once packed to bf16.

// Shared memory, bf16: sQ, sK, sV, each [64][DP + 8]. The 16-byte pad per
// row puts the 8 rows an ldmatrix reads in 8 different 16-byte bank groups.
template <int DP>
constexpr int mma_smem_bytes() {
  return 3 * kBQ * (DP + 8) * 2;
}



template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, Strides qs, Strides ks,
                      Strides vs, int H, int S, int D, float sm_scale,
                      int mode, int vec) {
  constexpr int P = DP + 8;
  constexpr int NT = kBK / 8;   // 8-key score tiles per key tile
  constexpr int OT = DP / 8;    // 8-wide output tiles
  extern __shared__ uint4 smem_bf16[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_bf16);
  bf16* sK = sQ + kBQ * P;
  bf16* sV = sK + kBK * P;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heavy causal tiles first
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile_bf16<DP>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S, D, vec);
  const bf16* kh = k + b * ks.b + h * ks.h;
  const bf16* vh = v + b * vs.b + h * vs.h;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
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

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DP; kd += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + (warp * 16 + (lane & 15)) * P + kd + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * P + kd +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // Scale, mask, online softmax; s becomes P (float32) in place.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qg = q0 + warp * 16 + g + r * 8;
      uint32_t keep = 0;
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[nt][r * 2 + c];
          x *= sm_scale;
          if (visible(mode, qg, k0 + nt * 8 + 2 * t + c, S)) {
            keep |= 1u << (nt * 2 + c);
          } else {
            x = kNegInf;
          }
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[nt][r * 2 + c];
          x = (keep >> (nt * 2 + c)) & 1u ? expf(x - m_new) : 0.f;
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] = l[r] * alpha + rs;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        acc[ot][r * 2] *= alpha;
        acc[ot][r * 2 + 1] *= alpha;
      }
    }

    // O += P V, 16 keys per step; P's accumulators are the A operand.
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int op = 0; op < OT / 2; ++op) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sV + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                  op * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * op], a, bv[0], bv[1]);
        mma_bf16(acc[2 * op + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qg = q0 + warp * 16 + g + r * 8;
    if (qg >= S) continue;
    const float l_safe = l[r] > 0.f ? l[r] : 1.f;
    bf16* orow = o + ((static_cast<long long>(b) * S + qg) * H + h) * D;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = ot * 8 + 2 * t + c;
        if (d < D) orow[d] = __float2bfloat16(acc[ot][r * 2 + c] / l_safe);
      }
    if (t == 0)
      lse[static_cast<long long>(bh) * S + qg] =
          l[r] > 0.f ? m[r] + logf(l_safe) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on Hopper: TMA ring, mbarriers and wgmma, warp-specialised.
//
// One block per (b*h, tile of query rows): TmaShape's consumer
// warpgroups of 64 rows each, then one producer warpgroup.
//   - The producer: one thread loads the Q tile once, then each K and V
//     tile of the block's key range into a ring of kTmaStages stages,
//     waiting on a stage's "empty" barrier before reusing it. Each load
//     completes on the stage's "full" barrier, K and V apart, so Q K^T
//     starts before V lands and K's slot frees before V's.
//   - The consumers, per tile of 128 keys: S = Q K^T by wgmma m64n128k16
//     with both operands in shared memory; the mask (only on tiles that
//     cross the diagonal or the ragged end) and the online softmax on the
//     accumulator registers; P packed to bf16 in place as the register A
//     operand of O += P V (wgmma m64nDPk16, V read transposed from shared
//     memory).
// Tiles are [rows][DP] bf16 in 64-column atoms, 128-byte swizzled
// (hopper.cuh): TMA writes them so and the descriptors read them so.
// Rows past S and columns past D arrive as zeros. The epilogue writes
// O / l through the warpgroup's own rows of the Q tile (no longer read),
// so that each row leaves in 16-byte stores, and LSE in float32.

constexpr int kTmaRows = 128;       // keys per tile
constexpr int kTmaStages = 2;
constexpr int kAtomBytes = kTmaRows * 128;  // 64 bf16 columns x 128 keys
constexpr float kLn2 = 0.6931471805599453f;

// A block's shape. D <= 64: one consumer warpgroup (64 query rows) and
// two blocks an SM, which run out of step, so one's softmax and start-up
// overlap the other's products; D <= 128: two consumer warpgroups (128
// rows), one block an SM (the K and V ring takes 128 KB). Registers:
// the launch bound gives 65536 / (threads x blocks) a thread at entry;
// setmaxnreg moves the producer's spare ones to the consumers.
template <int DP>
struct TmaShape {
  static constexpr int kConsumers = DP == 64 ? 1 : 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBlocksPerSM = DP == 64 ? 2 : 1;
  static constexpr int kRows = 64 * kConsumers;  // query rows per block
  static constexpr int kQAtom = kRows * 128;     // 64 columns of Q
  static constexpr int kQBytes = kQAtom * (DP / 64);
  static constexpr int kTile = kAtomBytes * (DP / 64);  // one K or V tile
  static constexpr int kProducerRegs = DP == 64 ? 24 : 40;
  static constexpr int kConsumerRegs = 232;
  // Q, then K and V of each stage, then the barriers, plus 1 KB so the
  // tiles can start on a 1024-byte boundary (the swizzle atom).
  static constexpr int kSmem =
      kQBytes + 2 * kTmaStages * kTile + 8 * (1 + 4 * kTmaStages) + 1024;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Mask where kMask, online softmax in log2 units (the scale folded into
// the exponent's FMA): s becomes P (float32) in place, m (scaled) and l
// (this thread's partial row sums) advance, and O is rescaled. Rows qg0
// and qg0 + 8; s[4 nb + 2 r + c] is row qg0 + 8 r, key
// k0 + 8 nb + 2 t + c.
template <int DP, bool kMask>
__device__ __forceinline__ void tma_softmax(float (&s)[64], float (&m)[2],
                                            float (&l)[2],
                                            float (&acc)[DP / 2],
                                            float scale_log2, int mode,
                                            int qg0, int k0, int t, int S) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qg = qg0 + 8 * r;
    // Keys [0, lim) are visible to row qg: one compare a score.
    const int lim = mode == 0 ? S : min(S, mode == 1 ? qg + 1 : qg);
    float mx = kNegInf;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * nb + 2 * r + c];
        if (kMask && k0 + 8 * nb + 2 * t + c >= lim) x = kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    const float alpha = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * nb + 2 * r + c];
        // explicit zero: the -1e30 sentinel is finite
        x = kMask && k0 + 8 * nb + 2 * t + c >= lim
                ? 0.f
                : fast_exp2(fmaf(x, scale_log2, -m_new));
        rs += x;
      }
    l[r] = l[r] * alpha + rs;
#pragma unroll
    for (int ob = 0; ob < DP / 8; ++ob) {
      acc[4 * ob + 2 * r] *= alpha;
      acc[4 * ob + 2 * r + 1] *= alpha;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TmaShape<DP>::kThreads,
                                  TmaShape<DP>::kBlocksPerSM)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, float* __restrict__ lse, int H,
                     int S, int D, float scale_log2, int mode) {
  using Sh = TmaShape<DP>;
  constexpr int kTile = Sh::kTile;
  extern __shared__ uint8_t smem_tma[];
  uint8_t* smem = smem_tma + ((1024 - (smem_u32(smem_tma) & 1023)) & 1023);
  uint8_t* kv = smem + Sh::kQBytes;  // stage st: K at 2 st, V at 2 st + 1
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(kv + kTile * 2 * kTmaStages);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kTmaStages;
  uint64_t* k_empty = v_full + kTmaStages;
  uint64_t* v_empty = k_empty + kTmaStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heavy causal tiles first
  const int q0 = qt * Sh::kRows;
  // Causal frontier: the key tile of the block's last row.
  const int n_tiles = mode == 0 ? (S + kTmaRows - 1) / kTmaRows
                                : (q0 + Sh::kRows - 1) / kTmaRows + 1;
  // A shuffle from lane 0 shows the compiler the role is warp-uniform,
  // and each role's branch compiles tighter for it.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kTmaStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], 128 * Sh::kConsumers);
      mbar_init(&v_empty[st], 128 * Sh::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == Sh::kConsumers) {
    // Producer. The roles never meet again: no block-wide barrier below.
    setmaxnreg_dec<Sh::kProducerRegs>();
    if (threadIdx.x == 128 * Sh::kConsumers) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_expect_tx(q_full, Sh::kQBytes);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        tma_load_4d(smem + c * Sh::kQAtom, &tq, q_full, 64 * c, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kTmaStages;
        const uint32_t vacant = ((j / kTmaStages) & 1) ^ 1;
        uint8_t* sK = kv + kTile * 2 * st;
        mbar_wait(&k_empty[st], vacant);
        mbar_expect_tx(&k_full[st], kTile);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          tma_load_4d(sK + c * kAtomBytes, &tk, &k_full[st], 64 * c,
                      j * kTmaRows, h, b);
        mbar_wait(&v_empty[st], vacant);
        mbar_expect_tx(&v_full[st], kTile);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          tma_load_4d(sK + kTile + c * kAtomBytes, &tv, &v_full[st], 64 * c,
                      j * kTmaRows, h, b);
      }
    }
  } else {
    setmaxnreg_inc<Sh::kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int qg0 = q0 + 64 * wg + 16 * warp + g;
    uint8_t* sQ = smem + 64 * 128 * wg;  // this warpgroup's 64 rows
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kTmaStages;
      const uint32_t parity = (j / kTmaStages) & 1;
      const uint8_t* sK = kv + kTile * 2 * st;
      const uint8_t* sV = sK + kTile;
      const int k0 = j * kTmaRows;

      // S = Q K^T over DP in steps of 16 columns (32 bytes along a row).
      float s[64];
      mbar_wait(&k_full[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int col = (kk % 4) * 32;
        wgmma_ss_n128(s, sw128_desc(sQ + (kk / 4) * Sh::kQAtom + col, 16, 1024),
                      sw128_desc(sK + (kk / 4) * kAtomBytes + col, 16, 1024),
                      kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&k_empty[st]);

      if ((mode != 0 && k0 + kTmaRows > q0 + 64 * wg) || k0 + kTmaRows > S) {
        tma_softmax<DP, true>(s, m, l, acc, scale_log2, mode, qg0, k0, t, S);
      } else {
        tma_softmax<DP, false>(s, m, l, acc, scale_log2, mode, qg0, k0, t,
                               S);
      }

      // P in bf16: keys 16 kb .. 16 kb + 15 are the m16n8k16 A fragment
      // made of the accumulators of key columns 16 kb and 16 kb + 8.
      uint32_t p[32];
#pragma unroll
      for (int kb = 0; kb < 8; ++kb)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[4 * kb + i] = pack_bf16(s[8 * kb + 2 * i], s[8 * kb + 2 * i + 1]);

      // O += P V over the tile's 128 keys, 16 (2 KB of V rows) a step.
      mbar_wait(&v_full[st], parity);
      fence_regs(p);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) {
        const uint64_t dv = sw128_desc(sV + kb * 16 * 128, kAtomBytes, 1024);
        if constexpr (DP == 64) {
          wgmma_rs_n64(acc, p[4 * kb], p[4 * kb + 1], p[4 * kb + 2],
                       p[4 * kb + 3], dv);
        } else {
          wgmma_rs_n128(acc, p[4 * kb], p[4 * kb + 1], p[4 * kb + 2],
                        p[4 * kb + 3], dv);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      mbar_arrive(&v_empty[st]);
    }

    // Epilogue. O / l goes into this warpgroup's rows of the Q tile (its
    // last read finished with the last wgmma), swizzled as the tiles are,
    // then leaves row by row in 16-byte stores.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // l = 0: acc = 0
      const int rr = 16 * warp + g + 8 * r;  // row in the warpgroup; % 8 = g
#pragma unroll
      for (int ob = 0; ob < DP / 8; ++ob)
        *reinterpret_cast<uint32_t*>(sQ + (ob / 8) * Sh::kQAtom + rr * 128 +
                                     ((ob % 8) ^ g) * 16 + 4 * t) =
            pack_bf16(acc[4 * ob + 2 * r] * inv, acc[4 * ob + 2 * r + 1] * inv);
      const int qg = qg0 + 8 * r;
      if (t == 0 && qg < S)
        lse[static_cast<long long>(bh) * S + qg] =
            l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNegInf;
    }
    named_barrier_sync(1 + wg, 128);
    constexpr int kUnits = DP / 8;  // 16-byte units of a row
#pragma unroll
    for (int i = 0; i < 64 * kUnits / 128; ++i) {
      const int rr = (tid + 128 * i) / kUnits, u = (tid + 128 * i) % kUnits;
      const int qg = q0 + 64 * wg + rr;
      const uint4 val = *reinterpret_cast<const uint4*>(
          sQ + (u / 8) * Sh::kQAtom + rr * 128 + ((u % 8) ^ (rr % 8)) * 16);
      if (qg < S && u * 8 < D)
        *reinterpret_cast<uint4*>(
            o + ((static_cast<long long>(b) * S + qg) * H + h) * D + u * 8) =
            val;
    }
  }
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int D, Strides qs,
               Strides ks, Strides vs, float sm_scale, int mode,
               cudaStream_t stream) {
  constexpr int bytes = fma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_f32_kernel<DP><<<dim3(B * H, (S + kBQ - 1) / kBQ), kFmaThreads,
                             bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, qs, ks, vs,
      H, S, D, sm_scale, mode);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int D, Strides qs,
                Strides ks, Strides vs, float sm_scale, int mode, int vec,
                cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16_kernel<DP><<<dim3(B * H, (S + kBQ - 1) / kBQ), kMmaThreads,
                              bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, qs, ks, vs, H,
      S, D, sm_scale, mode, vec);
  return static_cast<int>(cudaGetLastError());
}



template <int DP>
int launch_tma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int D, Strides qs, Strides ks,
               Strides vs, float sm_scale, int mode, cudaStream_t stream) {
  using Sh = TmaShape<DP>;
  CUtensorMap tq, tk, tv;
  int err = encode_bshd_bf16(&tq, q, B, S, H, D, qs.b, qs.s, qs.h, Sh::kRows);
  if (err == 0)
    err = encode_bshd_bf16(&tk, k, B, S, H, D, ks.b, ks.s, ks.h, kTmaRows);
  if (err == 0)
    err = encode_bshd_bf16(&tv, v, B, S, H, D, vs.b, vs.s, vs.h, kTmaRows);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_tma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::kSmem);
  if (cerr == cudaSuccess)  // room for kBlocksPerSM blocks
    cerr = cudaFuncSetAttribute(flash_fwd_tma_kernel<DP>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  flash_fwd_tma_kernel<DP><<<dim3(B * H, (S + Sh::kRows - 1) / Sh::kRows),
                             Sh::kThreads, Sh::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, H, S, D,
      sm_scale * 1.4426950408889634f, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// variant: 0 = float32 (FMA), 1 = bfloat16 through mma.sync, 2 = bfloat16
// through TMA and wgmma (D % 8 == 0 and every [B, S, H] row start 16-byte
// aligned). mode: 0 none, 1 diag, 2 strict. Strides are in elements, for
// the B, S and H dims of [B, S, H, D] (the D stride must be 1). Returns a
// cudaError_t (0 = launched); -1 for arguments the variant does not take;
// -2 where the driver refuses a tensor map.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, int variant, int B, int S, int H, int D,
                  long long qsb, long long qss, long long qsh,
                  long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh,
                  float sm_scale, int mode, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 128 || mode < 0 ||
      mode > 2 || variant < 0 || variant > 2 ||
      (S + kBQ - 1) / kBQ > 65535)
    return -1;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = D % 8 == 0 && aligned16(q, qs) && aligned16(k, ks) &&
                       aligned16(v, vs);
  if (variant == 0) {
    return D <= 64 ? launch_f32<64>(q, k, v, o, lse, B, S, H, D, qs, ks, vs,
                                    sm_scale, mode, st)
                   : launch_f32<128>(q, k, v, o, lse, B, S, H, D, qs, ks, vs,
                                     sm_scale, mode, st);
  }
  if (variant == 1) {
    return D <= 64 ? launch_bf16<64>(q, k, v, o, lse, B, S, H, D, qs, ks, vs,
                                     sm_scale, mode, aligned, st)
                   : launch_bf16<128>(q, k, v, o, lse, B, S, H, D, qs, ks,
                                      vs, sm_scale, mode, aligned, st);
  }
  if (!aligned) return -1;
  return D <= 64 ? launch_tma<64>(q, k, v, o, lse, B, S, H, D, qs, ks, vs,
                                  sm_scale, mode, st)
                 : launch_tma<128>(q, k, v, o, lse, B, S, H, D, qs, ks, vs,
                                   sm_scale, mode, st);
}

const char* hvd_cuda_error_string(int err) {
  if (err == -1) return "argument not supported by hvd_flash_fwd";
  if (err == -2) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
