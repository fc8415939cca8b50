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
//
// Storage types. The velocity (and the limited velocity) is of the state's
// type TV; the pair read, TI, and the pair returned, TO, are TV or float,
// because a chain of calls keeps its pair in float between calls and rounds
// it once at the end (fluid2d_tpu/models/common.py:98-119). p_bc and p_out
// are float planes while the launches read them: for TO = float the returned
// pair itself; for TO = bf16 scratch, beside which the BC launch writes the
// rounded p_bc and the even sweep, instead of updating in place, writes the
// rounded p_out of every cell.
#include "common.cuh"
#include "pressure.cuh"

using f2d::bf16;
using f2d::Grid;
using f2d::ld;
using f2d::predict_p;

namespace {

template <typename TA, typename TV>
__global__ void sor_odd_kernel(const float* __restrict__ p_bc, const TA* __restrict__ p_alt,
                               const TV* __restrict__ u, const TV* __restrict__ w,
                               const int8_t* __restrict__ fluid, float* __restrict__ out,
                               Grid g, float omega, float one_minus_omega, float dx,
                               float inv_eight_dt) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  if (fluid[k] != 0 && ((i + j) & 1)) {
    out[k] = one_minus_omega * p_bc[k] + omega * predict_p(p_bc, u, w, g, i, j, dx, inv_eight_dt);
  } else {
    out[k] = ld(p_alt, k);
  }
}

template <typename TV, typename TO>
__global__ void sor_even_kernel(float* pn, const TV* __restrict__ u, const TV* __restrict__ w,
                                const int8_t* __restrict__ fluid, TO* __restrict__ p_out_s,
                                TV* __restrict__ v_lim, Grid g, float omega,
                                float one_minus_omega, float dx, float inv_eight_dt,
                                float v_limit) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  const bool relax = fluid[k] != 0 && !((i + j) & 1);
  if constexpr (f2d::kIsBf16<TO>) {
    float r = pn[k];
    if (relax) r = one_minus_omega * r + omega * predict_p(pn, u, w, g, i, j, dx, inv_eight_dt);
    p_out_s[k] = __float2bfloat16_rn(r);
  } else if (relax) {
    pn[k] = one_minus_omega * pn[k] + omega * predict_p(pn, u, w, g, i, j, dx, inv_eight_dt);
  }
  if (v_lim != nullptr) f2d::limit_cell(u, w, v_lim, g, k, v_limit);
}

// p_out32, p_bc32: the float planes (p_out, p_bc themselves for TO = float).
template <typename TI, typename TO, typename TV>
int sor_iteration(const TI* p_cur, const TI* p_alt, const TV* u, const TV* w,
                  const int8_t* pbc_code, const int8_t* fluid8, TO* p_out, TO* p_bc,
                  float* p_out32, float* p_bc32, TV* v_lim, Grid g, float omega,
                  float one_minus_omega, float dx, float inv_eight_dt, float v_limit,
                  cudaStream_t s) {
  const dim3 blocks = f2d::launch_blocks(g.X, g.Y, 1), threads = f2d::launch_threads();
  f2d::pressure_bc_kernel<TI, TO><<<blocks, threads, 0, s>>>(p_cur, pbc_code, p_bc32, p_bc, g);
  F2D_CHECK_LAUNCH();
  sor_odd_kernel<TI, TV><<<blocks, threads, 0, s>>>(p_bc32, p_alt, u, w, fluid8, p_out32, g,
                                                    omega, one_minus_omega, dx, inv_eight_dt);
  F2D_CHECK_LAUNCH();
  sor_even_kernel<TV, TO><<<blocks, threads, 0, s>>>(p_out32, u, w, fluid8, p_out, v_lim, g,
                                                     omega, one_minus_omega, dx, inv_eight_dt,
                                                     v_limit);
  F2D_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// p_out, p_bc: (X, Y); v_lim: (2, X, Y) or null. Returns cudaGetLastError().
extern "C" int f2d_sor_iteration(const float* p_cur, const float* p_alt, const float* u,
                                 const float* w, const int8_t* pbc_code, const int8_t* fluid8,
                                 float* p_out, float* p_bc, float* v_lim, int X, int Y,
                                 float omega, float one_minus_omega, float dx, float inv_eight_dt,
                                 float v_limit, void* stream) {
  return sor_iteration<float, float, float>(p_cur, p_alt, u, w, pbc_code, fluid8, p_out, p_bc,
                                            p_out, p_bc, v_lim, Grid{X, Y}, omega,
                                            one_minus_omega, dx, inv_eight_dt, v_limit,
                                            static_cast<cudaStream_t>(stream));
}

// bf16 state: u, w and v_lim bf16; the pair read is bf16 if in_bf16 else
// float, the pair returned bf16 if out_bf16 else float. p_out32, p_bc32:
// (X, Y) float scratch for a bf16 result, else p_out and p_bc again.
extern "C" int f2d_sor_iteration_bf16(const void* p_cur, const void* p_alt, const bf16* u,
                                      const bf16* w, const int8_t* pbc_code,
                                      const int8_t* fluid8, void* p_out, void* p_bc,
                                      float* p_out32, float* p_bc32, bf16* v_lim, int X, int Y,
                                      int in_bf16, int out_bf16, float omega,
                                      float one_minus_omega, float dx, float inv_eight_dt,
                                      float v_limit, void* stream) {
  const Grid g{X, Y};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F2D_SOR(TI, TO)                                                                        \
  sor_iteration<TI, TO, bf16>(static_cast<const TI*>(p_cur), static_cast<const TI*>(p_alt), u, \
                              w, pbc_code, fluid8, static_cast<TO*>(p_out),                    \
                              static_cast<TO*>(p_bc), p_out32, p_bc32, v_lim, g, omega,         \
                              one_minus_omega, dx, inv_eight_dt, v_limit, s)
  if (in_bf16) return out_bf16 ? F2D_SOR(bf16, bf16) : F2D_SOR(bf16, float);
  return out_bf16 ? F2D_SOR(float, bf16) : F2D_SOR(float, float);
#undef F2D_SOR
}

extern "C" const char* f2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
