// One red-black SOR iteration, optionally with the velocity-norm limiter.
//
// Replaces fluid2d_tpu/ops/pallas_stencil.py:sor_iteration_pallas (core
// _sor_core, BC _pressure_bc_expr, prediction _predict_p_expr). The
// arithmetic is the port's eager ops/pressure.py operation for operation,
// rounded as PyTorch rounds it on the card (common.cuh). Three launches,
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

using f2d::Grid;

namespace {

__global__ void pressure_bc_kernel(const float* __restrict__ p,
                                   const int8_t* __restrict__ code,
                                   float* __restrict__ out, Grid g) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
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
  if (v_lim != nullptr) {
    // limit_vector_norm (fs/solver.py:38-43): a NaN norm compares false.
    const float uc = u[k], wc = w[k];
    const float norm = sqrtf(uc * uc + wc * wc);
    const bool over = norm > v_limit;
    v_lim[k] = over ? v_limit * (uc / norm) : uc;
    v_lim[g.plane() + k] = over ? v_limit * (wc / norm) : wc;
  }
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
  pressure_bc_kernel<<<blocks, threads, 0, s>>>(p_cur, pbc_code, p_bc, g);
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
