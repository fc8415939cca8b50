// Pressure boundary condition and pressure prediction, shared by the SOR
// iteration (sor.cu) and the Jacobi iteration (jacobi.cu).
//
// The arithmetic is the port's eager ops/pressure.py and
// scenes/runtime_bc.py:pressure_bc, rounded as PyTorch rounds it on the
// card (common.cuh). Internal linkage: every source that includes this
// header gets its own copy.
#pragma once

#include "common.cuh"

namespace f2d {
namespace {

// Pressure BC by pbc_code 0..10 (fs/boundary_condition.py:41-65), out of
// place: the inflow code 9 reads (i+1, j), which may itself be rewritten.
__global__ void pressure_bc_kernel(const float* __restrict__ p,
                                   const int8_t* __restrict__ code,
                                   float* __restrict__ out, Grid g) {
  int i, j;
  if (!cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  float r = p[k];
  switch (code[k]) {
    case 1: r = p[g.at(i - 1, j)]; break;
    case 2: r = p[g.at(i + 1, j)]; break;
    case 3: r = p[g.at(i, j - 1)]; break;
    case 4: r = p[g.at(i, j + 1)]; break;
    case 5: r = (p[g.at(i - 1, j)] + p[g.at(i, j + 1)]) / 2.0f; break;
    case 6: r = (p[g.at(i + 1, j)] + p[g.at(i, j + 1)]) / 2.0f; break;
    case 7: r = (p[g.at(i - 1, j)] + p[g.at(i, j - 1)]) / 2.0f; break;
    case 8: r = (p[g.at(i + 1, j)] + p[g.at(i, j - 1)]) / 2.0f; break;
    case 9: r = p[g.at(i + 1, j)]; break;
    case 10: r = 0.0f; break;
    default: break;
  }
  out[k] = r;
}

// predict_p (fs/pressure_updater.py:24-38); inv_eight_dt = 1/(8·dt) in float.
__device__ __forceinline__ float predict_p(const float* p, const float* __restrict__ u,
                                           const float* __restrict__ w, const Grid& g,
                                           int i, int j, float dx, float inv_eight_dt) {
  const float sub_x_u = u[g.at(i + 1, j)] - u[g.at(i - 1, j)];
  const float sub_x_w = w[g.at(i + 1, j)] - w[g.at(i - 1, j)];
  const float sub_y_u = u[g.at(i, j + 1)] - u[g.at(i, j - 1)];
  const float sub_y_w = w[g.at(i, j + 1)] - w[g.at(i, j - 1)];
  return 0.25f * (p[g.at(i + 1, j)] + p[g.at(i - 1, j)] + p[g.at(i, j + 1)] + p[g.at(i, j - 1)])
         + (sub_x_u * sub_x_u + sub_y_w * sub_y_w + (sub_y_u * sub_x_w)) / 8.0f
         - dx * (sub_x_u + sub_y_w) * inv_eight_dt;
}

// limit_vector_norm (fs/solver.py:38-43) of one cell: a NaN norm compares
// false and leaves the vector unchanged. v_lim is (2, X, Y).
__device__ __forceinline__ void limit_cell(const float* __restrict__ u,
                                           const float* __restrict__ w,
                                           float* __restrict__ v_lim, const Grid& g,
                                           long long k, float v_limit) {
  const float uc = u[k], wc = w[k];
  const float norm = sqrtf(uc * uc + wc * wc);
  const bool over = norm > v_limit;
  v_lim[k] = over ? v_limit * (uc / norm) : uc;
  v_lim[g.plane() + k] = over ? v_limit * (wc / norm) : wc;
}

}  // namespace
}  // namespace f2d
