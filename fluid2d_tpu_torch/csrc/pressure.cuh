// Pressure boundary condition, pressure prediction and the velocity-norm
// limiter: the per-cell rules shared by the fused SOR kernel (sor.cu) and the
// fused Jacobi kernel (jacobi.cu).
//
// The arithmetic is the port's eager ops/pressure.py and
// scenes/runtime_bc.py:pressure_bc, rounded as PyTorch rounds it on the
// card (common.cuh). The rules read their operands through cell accessors
// (common.cuh), here Windows of stage values in shared memory, so both
// kernels evaluate the same lines.
// Internal linkage: every source that includes this header gets its own copy.
#pragma once

#include "common.cuh"

namespace f2d {
namespace {

// A cell's flag byte in the fused pressure kernels' windows: its pbc_code
// (0..10) in the low bits, then whether the sweeps update the cell (SOR:
// fluid; Jacobi: not_wall).
constexpr unsigned kCode = 15u, kSwept = 1u << 4;

struct PressureFlags {  // fill_flags' packing of (pbc_code, swept) bytes
  __device__ __forceinline__ unsigned operator()(unsigned code, unsigned swept) const {
    return (code & kCode) | (swept != 0 ? kSwept : 0u);
  }
};

// The outputs of a fused pressure call, at a tile's cells.
template <typename TO, typename TV>
struct PressureOut {
  TO* p_out;
  TO* p_bc;
  TV* v_lim;  // null without the limiter
};

// Pressure BC at cell (i, j) by its pbc_code 0..10
// (fs/boundary_condition.py:41-65). p: the pressure before the BC, read at
// other cells, so a kernel writes the BC'd field out of place (the inflow
// code 9 reads (i+1, j), which may itself be rewritten).
template <typename A>
__device__ __forceinline__ float pressure_bc_cell(const A& p, int code, int i, int j) {
  switch (code) {
    case 1: return p(i - 1, j);
    case 2: return p(i + 1, j);
    case 3: return p(i, j - 1);
    case 4: return p(i, j + 1);
    case 5: return (p(i - 1, j) + p(i, j + 1)) / 2.0f;
    case 6: return (p(i + 1, j) + p(i, j + 1)) / 2.0f;
    case 7: return (p(i - 1, j) + p(i, j - 1)) / 2.0f;
    case 8: return (p(i + 1, j) + p(i, j - 1)) / 2.0f;
    case 9: return p(i + 1, j);
    case 10: return 0.0f;
    default: return p(i, j);
  }
}

// predict_p (fs/pressure_updater.py:24-38) at (i, j): p the pressure, u and w
// the velocity planes; inv_eight_dt = 1/(8·dt) in float.
template <typename P, typename V>
__device__ __forceinline__ float predict_p(const P& p, const V& u, const V& w, int i, int j,
                                           float dx, float inv_eight_dt) {
  const float sub_x_u = u(i + 1, j) - u(i - 1, j);
  const float sub_x_w = w(i + 1, j) - w(i - 1, j);
  const float sub_y_u = u(i, j + 1) - u(i, j - 1);
  const float sub_y_w = w(i, j + 1) - w(i, j - 1);
  return 0.25f * (p(i + 1, j) + p(i - 1, j) + p(i, j + 1) + p(i, j - 1))
         + (sub_x_u * sub_x_u + sub_y_w * sub_y_w + (sub_y_u * sub_x_w)) / 8.0f
         - dx * (sub_x_u + sub_y_w) * inv_eight_dt;
}

// limit_vector_norm (fs/solver.py:38-43) of one cell's velocity (uc, wc): a
// NaN norm compares false and leaves the vector unchanged.
__device__ __forceinline__ float2 limited(float uc, float wc, float v_limit) {
  const float norm = sqrtf(uc * uc + wc * wc);
  const bool over = norm > v_limit;
  return make_float2(over ? v_limit * (uc / norm) : uc, over ? v_limit * (wc / norm) : wc);
}

// The limited velocity of one cell stored: v_lim is (2, X, Y), of the
// velocity's storage type; k the cell's offset in a plane.
template <typename TV>
__device__ __forceinline__ void limit_cell(float uc, float wc, TV* __restrict__ v_lim,
                                           long long plane, long long k, float v_limit) {
  const float2 l = limited(uc, wc, v_limit);
  st(v_lim, k, l.x);
  st(v_lim, plane + k, l.y);
}

}  // namespace
}  // namespace f2d
