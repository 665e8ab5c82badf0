// BatchNorm paired reduction for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by horovod_tpu_torch/_build.py).
//
// Replaces: horovod_tpu/ops/pallas_norm.py::_paired_kernel (launched by
// paired_reduce). Same function: for a row-major [R, C] pair a, b (both
// bfloat16 or both float32), per channel c
//     s[c] = sum_r a[r, c]        p[c] = sum_r a[r, c] * b[r, c]
// accumulated and returned in float32. batch_norm_train calls it as (x, x)
// in the forward (sum, sum of squares) and as (dy, x) in the backward.
//
// What bounds it on an H100: bytes. It does three float32 operations an
// element (an add for s, a multiply and an add for p) and reads 2 (bf16) or
// 4 (f32) bytes of each input an element: at 67 TFLOP/s and 3.35 TB/s the
// operations take ~20x less time than the bytes. On ResNet-50 at B=128,
// 224x224, the largest inputs hold 102.8 M elements (bn_init's 1,605,632
// x 64 and stage 1's 401,408 x 256): the least time is ~61 us for (x, x),
// read once, and ~123 us for (dy, x).
//
// What the design does about it:
//   - every input byte is read once, 16 bytes a thread per load (8 bf16 or
//     4 f32 values), neighbouring threads on neighbouring addresses along C;
//     when a and b are the same tensor (the forward's (x, x)) it is read
//     once and squared, which halves the forward's bytes;
//   - the TPU kernel walks R on a sequential grid with a VMEM accumulator;
//     here R is split over about two blocks per SM (a grid-stride loop over
//     rows, four rows' loads in flight per thread), each thread sums its rows
//     in float32 registers, the block's row-threads are summed in shared
//     memory in a fixed order, and each block writes one float32 partial
//     row pair [2, C]. A second small kernel sums the partials over blocks,
//     again in a fixed order. No float atomics: a shape gives the same bits
//     from run to run, as the reference does;
//   - any C and any pointer: a scalar path (one element a load) takes C
//     that is not a multiple of the vector width and pointers that are not
//     16-byte aligned; ragged R is the loop's bound.
// Not yet done (later work): TMA loads, a persistent grid with the partial
// sum folded into the last block, fusing the (x, x) read into the producer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads of a partial-sum block
constexpr int kUnroll = 4;      // rows whose loads a thread keeps in flight
constexpr int kFinalThreads = 256;
constexpr int kFinalCols = 32;  // columns of a finalize block (x 8 lanes)

struct bf16_t {
  uint16_t bits;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// V elements of T at p as float32. V > 1 needs p 16-byte aligned.
template <typename T, int V>
struct Load;

template <>
struct Load<float, 4> {
  __device__ __forceinline__ static void run(const float* p, float (&o)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

template <>
struct Load<bf16_t, 8> {
  __device__ __forceinline__ static void run(const bf16_t* p, float (&o)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    o[0] = bf16_lo(v.x); o[1] = bf16_hi(v.x);
    o[2] = bf16_lo(v.y); o[3] = bf16_hi(v.y);
    o[4] = bf16_lo(v.z); o[5] = bf16_hi(v.z);
    o[6] = bf16_lo(v.w); o[7] = bf16_hi(v.w);
  }
};

template <>
struct Load<float, 1> {
  __device__ __forceinline__ static void run(const float* p, float (&o)[1]) {
    o[0] = __ldg(p);
  }
};

template <>
struct Load<bf16_t, 1> {
  __device__ __forceinline__ static void run(const bf16_t* p, float (&o)[1]) {
    o[0] = __uint_as_float(static_cast<uint32_t>(
                               __ldg(reinterpret_cast<const unsigned short*>(p)))
                           << 16);
  }
};

// Block (bx, by): vector columns [bx*tcol, (bx+1)*tcol) (each V channels),
// rows by*trow + ty, stepping by gridDim.y*trow. Thread (tx, ty) with
// tx = tid % tcol, ty = tid / tcol, trow = kThreads / tcol. Writes
// partial[by][0][c] = sum of a and partial[by][1][c] = sum of a*b over the
// block's rows, for the block's channels c < C.
template <typename T, int V, bool kSame>
__global__ void __launch_bounds__(kThreads, 2)
paired_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      float* __restrict__ partial, long long R, int C,
                      int tcol) {
  const int tx = threadIdx.x % tcol, ty = threadIdx.x / tcol;
  const int trow = kThreads / tcol;
  const int c0 = (blockIdx.x * tcol + tx) * V;
  float s[V], p[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = p[i] = 0.f;
  if (c0 < C) {   // V > 1 only when C % V == 0: the vector is whole
    const long long step = static_cast<long long>(gridDim.y) * trow;
    long long r = static_cast<long long>(blockIdx.y) * trow + ty;
    for (; r + (kUnroll - 1) * step < R; r += kUnroll * step) {
      float av[kUnroll][V], bv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long off = (r + u * step) * C + c0;
        Load<T, V>::run(a + off, av[u]);
        if (!kSame) Load<T, V>::run(b + off, bv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += av[u][i];
          p[i] = fmaf(av[u][i], kSame ? av[u][i] : bv[u][i], p[i]);
        }
      }
    }
    for (; r < R; r += step) {
      float av[V], bv[V];
      const long long off = r * C + c0;
      Load<T, V>::run(a + off, av);
      if (!kSame) Load<T, V>::run(b + off, bv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += av[i];
        p[i] = fmaf(av[i], kSame ? av[i] : bv[i], p[i]);
      }
    }
  }

  // The block's trow row-threads, summed per channel in order of ty.
  __shared__ float sh_s[kThreads * V], sh_p[kThreads * V];
  const int width = tcol * V;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh_s[ty * width + tx * V + i] = s[i];
    sh_p[ty * width + tx * V + i] = p[i];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < width; col += kThreads) {
    const int c = blockIdx.x * width + col;
    if (c >= C) continue;
    float ts = 0.f, tp = 0.f;
    for (int y = 0; y < trow; ++y) {
      ts += sh_s[y * width + col];
      tp += sh_p[y * width + col];
    }
    float* out = partial + static_cast<long long>(blockIdx.y) * 2 * C;
    out[c] = ts;
    out[C + c] = tp;
  }
}

// s[c] = sum_j partial[j][0][c], p[c] = sum_j partial[j][1][c] over the
// nparts partial rows: 8 lanes a column take every 8th row, then lane 0
// adds the 8 lane sums in order.
__global__ void __launch_bounds__(kFinalThreads)
paired_finalize_kernel(const float* __restrict__ partial,
                       float* __restrict__ s, float* __restrict__ p,
                       int nparts, int C) {
  constexpr int kLanes = kFinalThreads / kFinalCols;
  const int tx = threadIdx.x % kFinalCols, ty = threadIdx.x / kFinalCols;
  const int c = blockIdx.x * kFinalCols + tx;
  float ts = 0.f, tp = 0.f;
  if (c < C) {
    for (int j = ty; j < nparts; j += kLanes) {
      ts += partial[static_cast<long long>(j) * 2 * C + c];
      tp += partial[static_cast<long long>(j) * 2 * C + C + c];
    }
  }
  __shared__ float sh[2][kLanes][kFinalCols + 1];
  sh[0][ty][tx] = ts;
  sh[1][ty][tx] = tp;
  __syncthreads();
  if (ty == 0 && c < C) {
    float fs = 0.f, fp = 0.f;
    for (int y = 0; y < kLanes; ++y) {
      fs += sh[0][y][tx];
      fp += sh[1][y][tx];
    }
    s[c] = fs;
    p[c] = fp;
  }
}

// The split: tcol threads (a power of two up to 32) along the C / V vector
// columns, kThreads / tcol along rows; gx blocks cover the columns and gy
// blocks split R, with gx * gy about max_parts (so gy <= max_parts).
template <typename T, int V>
int launch(const void* a, const void* b, float* partial, float* s, float* p,
           long long R, int C, int max_parts, cudaStream_t st) {
  const int cg = (C + V - 1) / V;
  int tcol = 1;
  while (tcol < cg && tcol < 32) tcol *= 2;
  const int trow = kThreads / tcol;
  const int gx = (cg + tcol - 1) / tcol;
  long long gy = (R + trow - 1) / trow;
  const long long want = (max_parts + gx - 1) / gx;
  if (gy > want) gy = want;
  const dim3 grid(gx, static_cast<unsigned>(gy));
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (a == b)
    paired_partial_kernel<T, V, true><<<grid, kThreads, 0, st>>>(
        ta, tb, partial, R, C, tcol);
  else
    paired_partial_kernel<T, V, false><<<grid, kThreads, 0, st>>>(
        ta, tb, partial, R, C, tcol);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paired_finalize_kernel<<<(C + kFinalCols - 1) / kFinalCols, kFinalThreads,
                           0, st>>>(partial, s, p, static_cast<int>(gy), C);
  return cudaGetLastError();
}

bool aligned16(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

}  // namespace

extern "C" {

// a, b: row-major [R, C], both float32 (dtype 0) or both bfloat16 (dtype 1);
// a == b is allowed and reads the tensor once. s, p: float32 [C]. partial:
// float32 scratch of max_parts * 2 * C values; max_parts is also about how
// many partial-sum blocks cover the whole [R, C] (the wrapper passes two
// per SM). Returns a cudaError_t (0 = launched); -1 for arguments the
// kernel does not take.
int hvd_paired_reduce(const void* a, const void* b, float* partial, float* s,
                      float* p, int dtype, long long R, int C, int max_parts,
                      void* stream) {
  if (R <= 0 || C <= 0 || max_parts <= 0 || (dtype != 0 && dtype != 1) ||
      (C + kFinalCols - 1) / kFinalCols > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(a) && aligned16(b);
  if (dtype == 0) {
    return vec && C % 4 == 0
               ? launch<float, 4>(a, b, partial, s, p, R, C, max_parts, st)
               : launch<float, 1>(a, b, partial, s, p, R, C, max_parts, st);
  }
  return vec && C % 8 == 0
             ? launch<bf16_t, 8>(a, b, partial, s, p, R, C, max_parts, st)
             : launch<bf16_t, 1>(a, b, partial, s, p, R, C, max_parts, st);
}

const char* hvd_cuda_error_string(int err) {
  if (err == -1) return "argument not supported by hvd_paired_reduce";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
