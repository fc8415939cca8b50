// The bf16 probes: the dtype-rate chains (C5a) and the row-window copies
// (C5b). The third bf16 probe (C5c) is the mix twin of probes.cu at bf16.
//
// dtype_rate_kernel<T> — chained arithmetic per element, T = float or
//   bf162 (two bf16 lanes per instruction: the card's packed bf16
//   arithmetic).
//   Replaces scripts/vpu_dtype_probe.py (its Pallas kernel): does bf16
//   arithmetic run faster than f32? Bound: FFMA / HFMA2 issue, by
//   construction: one load and one store per `steps` dependent steps. Modes
//   (the script's op mixes; "passes" counts the script's element-ops per
//   element, the same for both types):
//     fma     a = fma(a, c1, c2)                                   1 pass
//     poly    a = fma(a·a, c3, fma(a, c1, c2))                     3 passes
//     select  a = fma(a, a > 0 ? c1 : −c1, c2)                     2 passes
//     cipmix  a = fma(fma(a·a, a > 0 ? c3 : −c3, a), c1, c2)       4 passes
//   The intrinsics of one step, float (one element) / bf162 (two):
//     fma     __fmaf_rn                  / __hfma2
//     poly    __fmul_rn, 2 __fmaf_rn     / __hmul2, 2 __hfma2
//     select  compare, select, __fmaf_rn / __hgt2, 2 __hfma2
//     cipmix  __fmul_rn, compare, select, 2 __fmaf_rn / __hmul2, __hgt2, 3 __hfma2
//   so each mode issues as many operations a step in both types; in the
//   select modes the bf16 select is an fma where the float one is a select.
//   Every step is an explicit fma/mul intrinsic (the library is built with
//   -fmad=false, under which a*b + c would be a separate multiply and add).
//   The constants are kernel arguments, so no chain folds, and they are
//   exact in bf16 with |c1| < 1 (ops/cuda_dtype_probes.py says why: one
//   step more or fewer changes every element, in both types). The bf16
//   select is __hgt2 (1 or 0 per lane) fed to an fma: 1·2c − c or 0·2c − c,
//   both exact.
//
// row_copy_kernel<T, kMode> — the three row-window copies of
//   scripts/bf16_dma_probe.py, each for T = float or bf16, one block:
//     tail     rows [8, 8+t) of x → shared (cp.async, 16 bytes a copy), out
//     head     rows [0, t+16) → shared; rows [8, 24) copied to rows [0, 16)
//              within shared memory; rows [0, t) out
//     realign  rows [0, t+16) → shared; win[8:] = win[:t+8] (all reads, a
//              barrier, then the writes: the ranges overlap); rows [0, t) out
//   out is (t, cols) float. The TPU question was whether sub-tile row
//   offsets of bf16 copy at all; here the question is whether 16-byte
//   asynchronous copies at an 8-row offset of a bf16 plane land intact.
//   Bound: bytes (a few KB; latency-bound in practice).
#include "common.cuh"

using f2d::bf16;
using bf162 = __nv_bfloat162;

namespace {

constexpr int kThreads = 256;
enum Mode { kFma = 0, kPoly = 1, kSelect = 2, kCipmix = 3 };

__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ bf162 fma_(bf162 a, bf162 b, bf162 c) { return __hfma2(a, b, c); }
__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ bf162 mul_(bf162 a, bf162 b) { return __hmul2(a, b); }

// c if a > 0 else −c; two_c = 2c and neg_c = −c (exact).
__device__ __forceinline__ float sel_(float a, float c, float, float neg_c) {
  return a > 0.0f ? c : neg_c;
}
__device__ __forceinline__ bf162 sel_(bf162 a, bf162, bf162 two_c, bf162 neg_c) {
  return __hfma2(__hgt2(a, __float2bfloat162_rn(0.0f)), two_c, neg_c);
}

template <typename T>
__device__ __forceinline__ T splat(float v);
template <>
__device__ __forceinline__ float splat<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf162 splat<bf162>(float v) { return __float2bfloat162_rn(v); }

template <typename T, int kMode>
__global__ void dtype_rate_kernel(const T* __restrict__ x, T* __restrict__ o, long long n,
                                  int steps, float c1f, float c2f, float c3f) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const T c1 = splat<T>(c1f), c2 = splat<T>(c2f), c3 = splat<T>(c3f);
  const T two_c1 = splat<T>(2.0f * c1f), neg_c1 = splat<T>(-c1f);
  const T two_c3 = splat<T>(2.0f * c3f), neg_c3 = splat<T>(-c3f);
  T a = x[k];
  for (int s = 0; s < steps; ++s) {
    if constexpr (kMode == kFma) {
      a = fma_(a, c1, c2);
    } else if constexpr (kMode == kPoly) {
      a = fma_(mul_(a, a), c3, fma_(a, c1, c2));
    } else if constexpr (kMode == kSelect) {
      a = fma_(a, sel_(a, c1, two_c1, neg_c1), c2);
    } else {
      a = fma_(fma_(mul_(a, a), sel_(a, c3, two_c3, neg_c3), a), c1, c2);
    }
  }
  o[k] = a;
}

template <typename T>
int dtype_rate(const T* x, T* o, long long n, int steps, int mode, float c1, float c2, float c3,
               cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  switch (mode) {
    case kFma: dtype_rate_kernel<T, kFma><<<blocks, kThreads, 0, s>>>(x, o, n, steps, c1, c2, c3); break;
    case kPoly: dtype_rate_kernel<T, kPoly><<<blocks, kThreads, 0, s>>>(x, o, n, steps, c1, c2, c3); break;
    case kSelect: dtype_rate_kernel<T, kSelect><<<blocks, kThreads, 0, s>>>(x, o, n, steps, c1, c2, c3); break;
    case kCipmix: dtype_rate_kernel<T, kCipmix><<<blocks, kThreads, 0, s>>>(x, o, n, steps, c1, c2, c3); break;
    default: return (int)cudaErrorInvalidValue;
  }
  F2D_CHECK_LAUNCH();
  return 0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// `rows` rows of `cols` elements from row `row0` of x into win, 16 bytes a
// copy, then wait for them.
template <typename T>
__device__ void fetch_rows(const T* __restrict__ x, T* win, int row0, int rows, int cols) {
  constexpr int kPer = 16 / sizeof(T);
  const int chunks = rows * cols / kPer;
  const T* src = x + (long long)row0 * cols;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) cp_async16(win + c * kPer, src + c * kPer);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

enum Copy { kTail = 0, kHead = 1, kRealign = 2 };

// One block; dynamic shared memory holds (t + 16) rows.
template <typename T, int kMode>
__global__ void row_copy_kernel(const T* __restrict__ x, float* __restrict__ out, int cols,
                                int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  if constexpr (kMode == kTail) {
    fetch_rows(x, win, 8, t, cols);
  } else {
    fetch_rows(x, win, 0, t + 16, cols);
    const int n = (kMode == kHead ? 16 : t + 8) * cols;
    const int dst = kMode == kHead ? 0 : 8 * cols;
    const int src = kMode == kHead ? 8 * cols : 0;
    // Read everything first, then write: the ranges overlap.
    constexpr int kMax = 32;  // elements a thread moves; the wrapper checks n
    T buf[kMax];
    int m = 0;
    for (int e = threadIdx.x; e < n; e += blockDim.x) buf[m++] = win[src + e];
    __syncthreads();
    m = 0;
    for (int e = threadIdx.x; e < n; e += blockDim.x) win[dst + e] = buf[m++];
    __syncthreads();
  }
  for (int e = threadIdx.x; e < t * cols; e += blockDim.x) out[e] = widen(win[e]);
}

template <typename T>
int row_copy(const T* x, float* out, int cols, int t, int mode, cudaStream_t s) {
  const size_t smem = (size_t)(t + 16) * cols * sizeof(T);
  switch (mode) {
    case kTail: row_copy_kernel<T, kTail><<<1, kThreads, smem, s>>>(x, out, cols, t); break;
    case kHead: row_copy_kernel<T, kHead><<<1, kThreads, smem, s>>>(x, out, cols, t); break;
    case kRealign: row_copy_kernel<T, kRealign><<<1, kThreads, smem, s>>>(x, out, cols, t); break;
    default: return (int)cudaErrorInvalidValue;
  }
  F2D_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// x, o: n floats; `steps` steps of mode 0..3 (fma, poly, select, cipmix).
extern "C" int f2d_dtype_rate(const float* x, float* o, long long n, int steps, int mode,
                              float c1, float c2, float c3, void* stream) {
  return dtype_rate<float>(x, o, n, steps, mode, c1, c2, c3, static_cast<cudaStream_t>(stream));
}

// x, o: n_pairs bf16 pairs (2·n_pairs bf16, 4-byte aligned).
extern "C" int f2d_dtype_rate_bf16(const bf162* x, bf162* o, long long n_pairs, int steps,
                                   int mode, float c1, float c2, float c3, void* stream) {
  return dtype_rate<bf162>(x, o, n_pairs, steps, mode, c1, c2, c3,
                           static_cast<cudaStream_t>(stream));
}

// x: (rows, cols) float, 16-byte aligned, cols·4 a multiple of 16; out: (t, cols)
// float; mode 0..2 (tail, head, realign).
extern "C" int f2d_row_copy(const float* x, float* out, int cols, int t, int mode, void* stream) {
  return row_copy<float>(x, out, cols, t, mode, static_cast<cudaStream_t>(stream));
}

// The same with x bf16 (cols·2 a multiple of 16).
extern "C" int f2d_row_copy_bf16(const bf16* x, float* out, int cols, int t, int mode,
                                 void* stream) {
  return row_copy<bf16>(x, out, cols, t, mode, static_cast<cudaStream_t>(stream));
}
