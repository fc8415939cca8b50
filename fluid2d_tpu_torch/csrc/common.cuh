// Shared index math and launch geometry for the fluid2d kernels.
//
// Every field is a row-major (C, X, Y) float32 tensor with Y contiguous;
// masks and codes are (X, Y) int8. One thread owns one cell: threadIdx.x
// runs along Y so a warp reads 32 consecutive floats, and blockIdx.z is
// the channel where channels are independent. Neighbour reads clamp to
// the grid edge, the semantics of the JAX package's shift_x / shift_y.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace f2d {

constexpr int kBlockY = 32;  // threads along the contiguous axis
constexpr int kBlockX = 8;   // threads along X

struct Grid {
  int X, Y;

  __device__ __forceinline__ long long plane() const { return (long long)X * Y; }

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
