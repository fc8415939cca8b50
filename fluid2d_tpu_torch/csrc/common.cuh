// Shared index math, launch geometry and storage types for the fluid2d kernels.
//
// Every field is a row-major (C, X, Y) tensor with Y contiguous; masks and
// codes are (X, Y) int8. One thread owns one cell: threadIdx.x runs along Y
// so a warp reads 32 consecutive elements, and blockIdx.z is the channel
// where channels are independent. Neighbour reads clamp to the grid edge,
// the semantics of the JAX package's shift_x / shift_y.
//
// Storage. A field in device memory is stored as `float` or `bf16` (the
// transport dtype of the state, SimConfig.dtype); all arithmetic is float.
// ld() widens on load (exact); a bf16 store rounds to nearest even
// (__float2bfloat16_rn), as PyTorch's .to(torch.bfloat16) does. A plane
// that a later launch of the same phase reads is kept in a float scratch
// plane; its bf16 copy, where it is also a phase output, is written beside
// it (st2) and never read back. So a phase rounds each output once, at the
// points where the JAX package's jnp path rounds (fluid2d_tpu/utils/dtypes.py).
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

__device__ __forceinline__ void st(float* p, long long k, float v) { p[k] = v; }
__device__ __forceinline__ void st(bf16* p, long long k, float v) { p[k] = __float2bfloat16_rn(v); }

// A value that later launches read (`wide`, float) and that is also a phase
// output of storage type S (`narrow`). For S = float the two are one plane
// and `narrow` is ignored. For S = bf16 either pointer may be null: `wide`
// when no later launch reads the value, `narrow` when it is no output.
template <typename S>
__device__ __forceinline__ void st2(float* wide, S* narrow, long long k, float v) {
  if constexpr (kIsBf16<S>) {
    if (wide != nullptr) wide[k] = v;
    if (narrow != nullptr) narrow[k] = __float2bfloat16_rn(v);
  } else {
    wide[k] = v;
  }
}

constexpr int kBlockY = 32;  // threads along the contiguous axis
constexpr int kBlockX = 8;   // threads along X

struct Grid {
  int X, Y;

  __host__ __device__ __forceinline__ long long plane() const { return (long long)X * Y; }

  // Flat offset of cell (clamp(i), clamp(j)) in one (X, Y) plane.
  __device__ __forceinline__ long long at(int i, int j) const {
    i = i < 0 ? 0 : (i >= X ? X - 1 : i);
    j = j < 0 ? 0 : (j >= Y ? Y - 1 : j);
    return (long long)i * Y + j;
  }
};

// The cell this thread owns; false for the threads past the ragged edge.
__device__ __forceinline__ bool cell_of(const Grid& g, int& i, int& j) {
  j = blockIdx.x * blockDim.x + threadIdx.x;
  i = blockIdx.y * blockDim.y + threadIdx.y;
  return i < g.X && j < g.Y;
}

inline dim3 launch_blocks(int X, int Y, int channels) {
  return dim3((Y + kBlockY - 1) / kBlockY, (X + kBlockX - 1) / kBlockX, channels);
}

inline dim3 launch_threads() { return dim3(kBlockY, kBlockX, 1); }

}  // namespace f2d

#define F2D_CHECK_LAUNCH()                     \
  do {                                         \
    cudaError_t err_ = cudaGetLastError();     \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)
