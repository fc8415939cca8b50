// Up to four chained Jacobi pressure iterations, optionally with the
// velocity-norm limiter.
//
// Replaces fluid2d_tpu/ops/pallas_stencil.py:jacobi_iteration_pallas (kernel
// _jacobi_kernel). The arithmetic is the port's eager
// ops/pressure.py:jacobi_pressure_iteration, chained, operation for
// operation and rounded as PyTorch rounds it on the card (common.cuh); the
// BC, the prediction and the limiter are those of pressure.cuh. Two
// launches per iteration, each over the whole grid:
//   1. pressure BC  p_in -> pc          (out of place: code 9 reads (i+1, j))
//   2. sweep        pc, alt -> pn       predict_p at every not-wall cell
//                                       (inflow and outflow included), the
//                                       alt value at walls
// Iteration 1 takes the caller's p_alt as alt; from iteration 2 on, alt is
// the previous iteration's BC'd buffer (the post-swap pair (pn, pc)). The
// result is the last (pn, pc). The limiter rides the last sweep launch.
//
// Buffers: each iteration writes a (pc, pn) pair; iterations of the same
// parity as the last write the output pair, the others a scratch pair, so
// no launch reads the buffer it writes.
#include "common.cuh"
#include "pressure.cuh"

using f2d::Grid;

namespace {

__global__ void jacobi_sweep_kernel(const float* __restrict__ pc, const float* __restrict__ alt,
                                    const float* __restrict__ u, const float* __restrict__ w,
                                    const int8_t* __restrict__ not_wall, float* __restrict__ pn,
                                    float* __restrict__ v_lim, Grid g, float dx,
                                    float inv_eight_dt, float v_limit) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  pn[k] = not_wall[k] != 0 ? f2d::predict_p(pc, u, w, g, i, j, dx, inv_eight_dt) : alt[k];
  if (v_lim != nullptr) f2d::limit_cell(u, w, v_lim, g, k, v_limit);
}

}  // namespace

// p_cur, p_alt, u, w, out_pn, out_pc, s_pn, s_pc: (X, Y); s_pn and s_pc are
// scratch (unused, may be null, when n_iters is 1); v_lim: (2, X, Y) or
// null. Returns cudaGetLastError(), or cudaErrorInvalidValue for n_iters
// outside 1..4.
extern "C" int f2d_jacobi_iteration(const float* p_cur, const float* p_alt, const float* u,
                                    const float* w, const int8_t* pbc_code,
                                    const int8_t* not_wall8, float* out_pn, float* out_pc,
                                    float* s_pn, float* s_pc, float* v_lim, int X, int Y,
                                    int n_iters, float dx, float inv_eight_dt, float v_limit,
                                    void* stream) {
  if (n_iters < 1 || n_iters > 4) return (int)cudaErrorInvalidValue;
  const Grid g{X, Y};
  const dim3 blocks = f2d::launch_blocks(X, Y, 1), threads = f2d::launch_threads();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p_in = p_cur;
  const float* alt = p_alt;
  for (int it = 0; it < n_iters; ++it) {
    const bool last_parity = ((n_iters - 1 - it) & 1) == 0;
    float* pc = last_parity ? out_pc : s_pc;
    float* pn = last_parity ? out_pn : s_pn;
    const bool last = it == n_iters - 1;
    f2d::pressure_bc_kernel<<<blocks, threads, 0, s>>>(p_in, pbc_code, pc, g);
    F2D_CHECK_LAUNCH();
    jacobi_sweep_kernel<<<blocks, threads, 0, s>>>(pc, alt, u, w, not_wall8, pn,
                                                   last ? v_lim : nullptr, g, dx, inv_eight_dt,
                                                   v_limit);
    F2D_CHECK_LAUNCH();
    p_in = pn;
    alt = pc;
  }
  return 0;
}
