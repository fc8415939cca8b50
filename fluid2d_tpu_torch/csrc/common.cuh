// Shared index math, launch geometry and storage types for the fluid2d kernels.
//
// Every field is a row-major (C, X, Y) tensor with Y contiguous; masks and
// codes are (X, Y) int8. The phase kernels and the standalone advection work
// on tiles (tile.cuh); a probe kernel that owns one cell a thread runs
// threadIdx.x along Y, so a warp reads 32 consecutive elements (cell_of).
// Neighbour reads clamp to the grid edge, the semantics of the JAX package's
// shift_x / shift_y.
//
// Storage. A field in device memory is stored as `float` or `bf16` (the
// transport dtype of the state, SimConfig.dtype); all arithmetic is float.
// ld() widens on load (exact); a bf16 store rounds to nearest even
// (__float2bfloat16_rn), as PyTorch's .to(torch.bfloat16) does. A stage
// result that a later stage reads stays float (the fused kernels'
// shared-memory windows, tile.cuh), so a phase rounds each output once, at
// the points where the JAX package's jnp path rounds
// (fluid2d_tpu/utils/dtypes.py).
//
// Rounding. Each kernel evaluates the port's eager PyTorch expression in the
// same operation order and rounds where PyTorch's CUDA eager ops round, so
// that the two paths agree to the bit on the card: the library is built with
// -fmad=false (PyTorch rounds every product before the sum), and a division
// by a grid constant is a multiplication by its reciprocal (taken in double,
// rounded to float), which is how PyTorch's CUDA kernels divide a tensor by
// a Python scalar (ops/launch.py:recip32). Exact
// agreement matters because the step has discontinuities that turn one-ulp
// differences into jumps: the confinement force is +0.1 where the gradient
// of |curl| is exactly zero (0/0 → NaN → fminf) and ~0 where it is not,
// a jump of dt·ε·0.1 in v per step (docs/PARITY.md §4).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace f2d {

using bf16 = __nv_bfloat16;

template <typename T>
inline constexpr bool kIsBf16 = std::is_same_v<T, bf16>;

__device__ __forceinline__ float ld(const float* p, long long k) { return p[k]; }
__device__ __forceinline__ float ld(const bf16* p, long long k) { return __bfloat162float(p[k]); }

// ld through the read-only data cache, for planes no thread of the kernel writes.
__device__ __forceinline__ float ldg(const float* p, long long k) { return __ldg(p + k); }
__device__ __forceinline__ float ldg(const bf16* p, long long k) {
  return __bfloat162float(__ldg(p + k));
}

__device__ __forceinline__ void st(float* p, long long k, float v) { p[k] = v; }
__device__ __forceinline__ void st(bf16* p, long long k, float v) { p[k] = __float2bfloat16_rn(v); }

// Two neighbouring elements k, k + 1 stored at once; k even.
__device__ __forceinline__ void st_pair(float* p, long long k, float a, float b) {
  *reinterpret_cast<float2*>(p + k) = make_float2(a, b);
}
__device__ __forceinline__ void st_pair(bf16* p, long long k, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + k) =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

constexpr int kBlockY = 32;  // threads along the contiguous axis

struct Grid {
  int X, Y;

  __host__ __device__ __forceinline__ long long plane() const { return (long long)X * Y; }

  __device__ __forceinline__ int clamp_i(int i) const { return i < 0 ? 0 : (i >= X ? X - 1 : i); }
  __device__ __forceinline__ int clamp_j(int j) const { return j < 0 ? 0 : (j >= Y ? Y - 1 : j); }

  // Flat offset of cell (clamp(i), clamp(j)) in one (X, Y) plane.
  __device__ __forceinline__ long long at(int i, int j) const {
    return (long long)clamp_i(i) * Y + clamp_j(j);
  }
};

// Cell accessors: a stage's per-cell arithmetic (bc.cuh, cip_advect.cuh,
// cip_phases.cu) reads its operands as a(i, j), so one source line serves a
// kernel that reads device memory and one that reads shared memory.
//
// Plane: one (X, Y) plane of storage type T in device memory, read at the
// clamped cell (the jnp path's clamp-to-edge shifts) and widened to float.
template <typename T>
struct Plane {
  const T* p;
  Grid g;
  __device__ __forceinline__ float operator()(int i, int j) const { return ldg(p, g.at(i, j)); }
};

// Window: values in shared memory for rows i0.. and columns j0.. of the
// grid, row pitch W (float stage values, or per-cell flag bytes). Every
// entry holds the value at the clamped cell, so a read past the grid's edge
// gives what Plane gives: no clamp.
template <int W, typename T = float>
struct Window {
  T* s;
  int i0, j0;
  __device__ __forceinline__ int idx(int i, int j) const { return (i - i0) * W + (j - j0); }
  __device__ __forceinline__ T operator()(int i, int j) const { return s[idx(i, j)]; }
};

// The cell this thread owns; false for the threads past the ragged edge.
__device__ __forceinline__ bool cell_of(const Grid& g, int& i, int& j) {
  j = blockIdx.x * blockDim.x + threadIdx.x;
  i = blockIdx.y * blockDim.y + threadIdx.y;
  return i < g.X && j < g.Y;
}

}  // namespace f2d

#define F2D_CHECK_LAUNCH()                     \
  do {                                         \
    cudaError_t err_ = cudaGetLastError();     \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)
