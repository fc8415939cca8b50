// One red-black SOR iteration, optionally with the velocity-norm limiter.
//
// Replaces fluid2d_tpu/ops/pallas_stencil.py:sor_iteration_pallas (core
// _sor_core, BC _pressure_bc_expr, prediction _predict_p_expr). The
// arithmetic is the port's eager ops/pressure.py operation for operation,
// rounded as PyTorch rounds it on the card (common.cuh); the BC, the
// prediction and the limiter are those of pressure.cuh. Three launches,
// each over the whole grid:
//   1. pressure BC  p_cur -> p_bc   (out of place: the inflow code 9 reads
//                                    (i+1, j), which may itself be rewritten)
//   2. odd sweep    p_bc, p_alt -> p_out (every cell: the relaxed value at
//                                    odd fluid cells, the alt value elsewhere)
//   3. even sweep   p_out in place  (even cells read only odd neighbours and
//                                    themselves, so it is race-free as a
//                                    separate launch after the odd sweep);
//                   the same launch writes the limited velocity if asked.
// Parity is the global (i + j) % 2.
#include "common.cuh"
#include "pressure.cuh"

using f2d::Grid;
using f2d::predict_p;

namespace {

__global__ void sor_odd_kernel(const float* __restrict__ p_bc, const float* __restrict__ p_alt,
                               const float* __restrict__ u, const float* __restrict__ w,
                               const int8_t* __restrict__ fluid, float* __restrict__ out,
                               Grid g, float omega, float one_minus_omega, float dx,
                               float inv_eight_dt) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  if (fluid[k] != 0 && ((i + j) & 1)) {
    out[k] = one_minus_omega * p_bc[k] + omega * predict_p(p_bc, u, w, g, i, j, dx, inv_eight_dt);
  } else {
    out[k] = p_alt[k];
  }
}

__global__ void sor_even_kernel(float* pn, const float* __restrict__ u,
                                const float* __restrict__ w, const int8_t* __restrict__ fluid,
                                float* __restrict__ v_lim, Grid g, float omega,
                                float one_minus_omega, float dx, float inv_eight_dt,
                                float v_limit) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  if (fluid[k] != 0 && !((i + j) & 1)) {
    pn[k] = one_minus_omega * pn[k] + omega * predict_p(pn, u, w, g, i, j, dx, inv_eight_dt);
  }
  if (v_lim != nullptr) f2d::limit_cell(u, w, v_lim, g, k, v_limit);
}

}  // namespace

// p_out, p_bc: (X, Y); v_lim: (2, X, Y) or null. Returns cudaGetLastError().
extern "C" int f2d_sor_iteration(const float* p_cur, const float* p_alt, const float* u,
                                 const float* w, const int8_t* pbc_code, const int8_t* fluid8,
                                 float* p_out, float* p_bc, float* v_lim, int X, int Y,
                                 float omega, float one_minus_omega, float dx, float inv_eight_dt,
                                 float v_limit, void* stream) {
  const Grid g{X, Y};
  const dim3 blocks = f2d::launch_blocks(X, Y, 1), threads = f2d::launch_threads();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  f2d::pressure_bc_kernel<<<blocks, threads, 0, s>>>(p_cur, pbc_code, p_bc, g);
  F2D_CHECK_LAUNCH();
  sor_odd_kernel<<<blocks, threads, 0, s>>>(p_bc, p_alt, u, w, fluid8, p_out, g, omega,
                                            one_minus_omega, dx, inv_eight_dt);
  F2D_CHECK_LAUNCH();
  sor_even_kernel<<<blocks, threads, 0, s>>>(p_out, u, w, fluid8, v_lim, g, omega,
                                             one_minus_omega, dx, inv_eight_dt, v_limit);
  F2D_CHECK_LAUNCH();
  return 0;
}

extern "C" const char* f2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
