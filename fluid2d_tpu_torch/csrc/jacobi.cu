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
// Buffers: each iteration writes a float (pc, pn) pair; iterations of the
// same parity as the last write the wide pair, the others a scratch pair,
// so no launch reads the buffer it writes.
//
// Storage types, as in sor.cu: the velocity and the limited velocity are TV;
// the pair read is TI and the pair returned TO (each TV or float). Only the
// first iteration reads the TI pair; the iterations chain through float
// planes. For TO = float the wide pair is the returned pair; for TO = bf16
// it is scratch, and the last iteration writes the rounded pair beside it.
#include "common.cuh"
#include "pressure.cuh"

using f2d::bf16;
using f2d::Grid;
using f2d::ld;

namespace {

template <typename TA, typename TV, typename TO>
__global__ void jacobi_sweep_kernel(const float* __restrict__ pc, const TA* __restrict__ alt,
                                    const TV* __restrict__ u, const TV* __restrict__ w,
                                    const int8_t* __restrict__ not_wall, float* __restrict__ pn,
                                    TO* __restrict__ pn_s, TV* __restrict__ v_lim, Grid g,
                                    float dx, float inv_eight_dt, float v_limit) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  f2d::st2(pn, pn_s, k,
           not_wall[k] != 0 ? f2d::predict_p(pc, u, w, g, i, j, dx, inv_eight_dt) : ld(alt, k));
  if (v_lim != nullptr) f2d::limit_cell(u, w, v_lim, g, k, v_limit);
}

// One iteration: the BC of p_in into pc (and its rounded copy pc_s), then
// the sweep into pn (and pn_s).
template <typename TA, typename TV, typename TO>
int jacobi_once(const TA* p_in, const TA* alt, const TV* u, const TV* w, const int8_t* pbc_code,
                const int8_t* not_wall8, float* pc, TO* pc_s, float* pn, TO* pn_s, TV* v_lim,
                Grid g, float dx, float inv_eight_dt, float v_limit, cudaStream_t s) {
  const dim3 blocks = f2d::launch_blocks(g.X, g.Y, 1), threads = f2d::launch_threads();
  f2d::pressure_bc_kernel<TA, TO><<<blocks, threads, 0, s>>>(p_in, pbc_code, pc, pc_s, g);
  F2D_CHECK_LAUNCH();
  jacobi_sweep_kernel<TA, TV, TO><<<blocks, threads, 0, s>>>(pc, alt, u, w, not_wall8, pn, pn_s,
                                                             v_lim, g, dx, inv_eight_dt, v_limit);
  F2D_CHECK_LAUNCH();
  return 0;
}

// w_pn, w_pc: the wide pair (out_pn, out_pc themselves for TO = float).
template <typename TI, typename TO, typename TV>
int jacobi_chain(const TI* p_cur, const TI* p_alt, const TV* u, const TV* w,
                 const int8_t* pbc_code, const int8_t* not_wall8, TO* out_pn, TO* out_pc,
                 float* w_pn, float* w_pc, float* s_pn, float* s_pc, TV* v_lim, Grid g,
                 int n_iters, float dx, float inv_eight_dt, float v_limit, cudaStream_t s) {
  if (n_iters < 1 || n_iters > 4) return (int)cudaErrorInvalidValue;
  const float* p_in = nullptr;
  const float* alt = nullptr;
  for (int it = 0; it < n_iters; ++it) {
    const bool last_parity = ((n_iters - 1 - it) & 1) == 0;
    float* pc = last_parity ? w_pc : s_pc;
    float* pn = last_parity ? w_pn : s_pn;
    const bool last = it == n_iters - 1;
    TO* pc_s = last ? out_pc : nullptr;
    TO* pn_s = last ? out_pn : nullptr;
    if (last && f2d::kIsBf16<TO>) pn = nullptr;  // no later launch reads it
    TV* lim = last ? v_lim : nullptr;
    const int rc = it == 0 ? jacobi_once(p_cur, p_alt, u, w, pbc_code, not_wall8, pc, pc_s, pn,
                                         pn_s, lim, g, dx, inv_eight_dt, v_limit, s)
                           : jacobi_once(p_in, alt, u, w, pbc_code, not_wall8, pc, pc_s, pn,
                                         pn_s, lim, g, dx, inv_eight_dt, v_limit, s);
    if (rc != 0) return rc;
    p_in = pn;
    alt = pc;
  }
  return 0;
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
  return jacobi_chain<float, float, float>(p_cur, p_alt, u, w, pbc_code, not_wall8, out_pn,
                                           out_pc, out_pn, out_pc, s_pn, s_pc, v_lim, Grid{X, Y},
                                           n_iters, dx, inv_eight_dt, v_limit,
                                           static_cast<cudaStream_t>(stream));
}

// bf16 state: u, w and v_lim bf16; the pair read is bf16 if in_bf16 else
// float, the pair returned bf16 if out_bf16 else float. w_pn, w_pc: (X, Y)
// float scratch for a bf16 result, else out_pn and out_pc again.
extern "C" int f2d_jacobi_iteration_bf16(const void* p_cur, const void* p_alt, const bf16* u,
                                         const bf16* w, const int8_t* pbc_code,
                                         const int8_t* not_wall8, void* out_pn, void* out_pc,
                                         float* w_pn, float* w_pc, float* s_pn, float* s_pc,
                                         bf16* v_lim, int X, int Y, int n_iters, int in_bf16,
                                         int out_bf16, float dx, float inv_eight_dt,
                                         float v_limit, void* stream) {
  const Grid g{X, Y};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F2D_JACOBI(TI, TO)                                                                      \
  jacobi_chain<TI, TO, bf16>(static_cast<const TI*>(p_cur), static_cast<const TI*>(p_alt), u, w, \
                             pbc_code, not_wall8, static_cast<TO*>(out_pn),                     \
                             static_cast<TO*>(out_pc), w_pn, w_pc, s_pn, s_pc, v_lim, g,         \
                             n_iters, dx, inv_eight_dt, v_limit, s)
  if (in_bf16) return out_bf16 ? F2D_JACOBI(bf16, bf16) : F2D_JACOBI(bf16, float);
  return out_bf16 ? F2D_JACOBI(float, bf16) : F2D_JACOBI(float, float);
#undef F2D_JACOBI
}
