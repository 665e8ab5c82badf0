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
// What bounds it on an H100: at the serving and training width (B=8,
// S=512, H=16, D=64, causal) the call moves ~34 MB (Q, K, V, O in bf16)
// against ~4.3 GFLOP, so the memory bound (~10 us at 3.35 TB/s) is above
// the bf16 tensor-core bound (~4.4 us); at S=4096 the causal work is 34
// GFLOP against 8.7 MB, and operations bound it (~35 us).
//
// What the design does about it: each (b*h, 64-query tile) thread block
// reads Q once and each K/V tile it needs once from device memory into
// shared memory, and keeps S and P out of device memory entirely.
//   - bf16 (the model's compute dtype): tensor cores through mma.sync
//     m16n8k16 (bf16 in, f32 accumulate), 4 warps of 16 query rows each;
//     S stays in registers, P is rounded to bf16 in registers to feed
//     the P.V product. This is the simple tensor-core kernel: no wgmma,
//     TMA, warp specialisation or copy/compute overlap yet.
//   - float32: FMAs on float32 shared-memory tiles (no tensor cores, so
//     the f32 CUDA-core rate bounds it); it keeps f32 inputs exact, which
//     the serving check relies on.

#include "flash_common.cuh"

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


}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mode: 0 none, 1 diag, 2 strict.
// Strides are in elements, for the B, S and H dims of [B, S, H, D]
// (the D stride must be 1). Returns a cudaError_t (0 = launched);
// -1 for arguments the kernel does not take.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, int dtype, int B, int S, int H, int D,
                  long long qsb, long long qss, long long qsh,
                  long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh,
                  float sm_scale, int mode, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 128 || mode < 0 ||
      mode > 2 || (dtype != 0 && dtype != 1) ||
      (S + kBQ - 1) / kBQ > 65535)
    return -1;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return D <= 64 ? launch_f32<64>(q, k, v, o, lse, B, S, H, D, qs, ks, vs,
                                    sm_scale, mode, st)
                   : launch_f32<128>(q, k, v, o, lse, B, S, H, D, qs, ks, vs,
                                     sm_scale, mode, st);
  }
  const int vec = D % 8 == 0 && aligned16(q, qs) && aligned16(k, ks) &&
                  aligned16(v, vs);
  return D <= 64 ? launch_bf16<64>(q, k, v, o, lse, B, S, H, D, qs, ks, vs,
                                   sm_scale, mode, vec, st)
                 : launch_bf16<128>(q, k, v, o, lse, B, S, H, D, qs, ks, vs,
                                    sm_scale, mode, vec, st);
}

const char* hvd_cuda_error_string(int err) {
  if (err == -1) return "argument not supported by hvd_flash_fwd";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
