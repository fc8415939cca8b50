// Pressure boundary condition and pressure prediction, shared by the SOR
// iteration (sor.cu) and the Jacobi iteration (jacobi.cu).
//
// The arithmetic is the port's eager ops/pressure.py and
// scenes/runtime_bc.py:pressure_bc, rounded as PyTorch rounds it on the
// card (common.cuh). The pressure being iterated is read from float planes
// except by the BC of a call's first iteration, which reads the caller's
// pair (storage type TI); the velocity is of the state's storage type TV.
// Internal linkage: every source that includes this header gets its own copy.
#pragma once

#include "common.cuh"

namespace f2d {
namespace {

// Pressure BC by pbc_code 0..10 (fs/boundary_condition.py:41-65), out of
// place: the inflow code 9 reads (i+1, j), which may itself be rewritten.
// The result goes to the float plane `out` and (st2) to its rounded copy
// `out_s` where it is a returned pressure of storage type TO.
template <typename TI, typename TO>
__global__ void pressure_bc_kernel(const TI* __restrict__ p, const int8_t* __restrict__ code,
                                   float* __restrict__ out, TO* __restrict__ out_s, Grid g) {
  int i, j;
  if (!cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  float r = ld(p, k);
  switch (code[k]) {
    case 1: r = ld(p, g.at(i - 1, j)); break;
    case 2: r = ld(p, g.at(i + 1, j)); break;
    case 3: r = ld(p, g.at(i, j - 1)); break;
    case 4: r = ld(p, g.at(i, j + 1)); break;
    case 5: r = (ld(p, g.at(i - 1, j)) + ld(p, g.at(i, j + 1))) / 2.0f; break;
    case 6: r = (ld(p, g.at(i + 1, j)) + ld(p, g.at(i, j + 1))) / 2.0f; break;
    case 7: r = (ld(p, g.at(i - 1, j)) + ld(p, g.at(i, j - 1))) / 2.0f; break;
    case 8: r = (ld(p, g.at(i + 1, j)) + ld(p, g.at(i, j - 1))) / 2.0f; break;
    case 9: r = ld(p, g.at(i + 1, j)); break;
    case 10: r = 0.0f; break;
    default: break;
  }
  st2(out, out_s, k, r);
}

// predict_p (fs/pressure_updater.py:24-38); inv_eight_dt = 1/(8·dt) in float.
template <typename TV>
__device__ __forceinline__ float predict_p(const float* p, const TV* __restrict__ u,
                                           const TV* __restrict__ w, const Grid& g,
                                           int i, int j, float dx, float inv_eight_dt) {
  const float sub_x_u = ld(u, g.at(i + 1, j)) - ld(u, g.at(i - 1, j));
  const float sub_x_w = ld(w, g.at(i + 1, j)) - ld(w, g.at(i - 1, j));
  const float sub_y_u = ld(u, g.at(i, j + 1)) - ld(u, g.at(i, j - 1));
  const float sub_y_w = ld(w, g.at(i, j + 1)) - ld(w, g.at(i, j - 1));
  return 0.25f * (p[g.at(i + 1, j)] + p[g.at(i - 1, j)] + p[g.at(i, j + 1)] + p[g.at(i, j - 1)])
         + (sub_x_u * sub_x_u + sub_y_w * sub_y_w + (sub_y_u * sub_x_w)) / 8.0f
         - dx * (sub_x_u + sub_y_w) * inv_eight_dt;
}

// limit_vector_norm (fs/solver.py:38-43) of one cell: a NaN norm compares
// false and leaves the vector unchanged. v_lim is (2, X, Y), of the
// velocity's storage type.
template <typename TV>
__device__ __forceinline__ void limit_cell(const TV* __restrict__ u, const TV* __restrict__ w,
                                           TV* __restrict__ v_lim, const Grid& g, long long k,
                                           float v_limit) {
  const float uc = ld(u, k), wc = ld(w, k);
  const float norm = sqrtf(uc * uc + wc * wc);
  const bool over = norm > v_limit;
  st(v_lim, k, over ? v_limit * (uc / norm) : uc);
  st(v_lim, g.plane() + k, over ? v_limit * (wc / norm) : wc);
}

}  // namespace
}  // namespace f2d
