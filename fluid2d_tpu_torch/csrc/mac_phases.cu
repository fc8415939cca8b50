// The MAC velocity phase and the MAC dye phase, upwind or Kawamura-Kuwahara.
//
// Replace fluid2d_tpu/ops/pallas_phases.py:mac_velocity_phase_pallas (core
// _mac_velocity_core) and mac_dye_phase_pallas (_mac_dye_kernel and its
// variants). The arithmetic is the port's eager path (the jnp branches of
// fluid2d_tpu/models/mac.py, fluid2d_tpu_torch/ops/advection.py) operation
// for operation, rounded as PyTorch rounds it on the card (common.cuh):
// every difference is divided by its grid constant separately, as the jnp
// stencils do, not with 1/dx factored out of the sums as the Pallas window
// helpers do. Two launches per phase:
//   1. BC      state -> f_bc  (the new alternate buffer, an output; bc.cuh)
//   2. update  f_bc  -> f_cur at fluid cells, the old alternate elsewhere
//      velocity: f_bc + dt·((−adv(f_bc) − ∇p) + ∇²f_bc/Re)
//      dye:      f_bc − dt·adv(f_bc) by the limited velocity, then the
//                [0, 1] clamp (fminf/fmaxf: NaN → 0) on every cell
// The BC'd field is in device memory before the update reads it, so the
// KK stencil's ±2 reads clamp at the grid ends exactly as the jnp path's
// shifts of the computed field do (what the Pallas kernels rebuild with
// _reclamp).
//
// Storage type S (common.cuh): the state's planes, the scene's constants and
// both outputs are S. The BC'd field, which the update launch reads, is a
// float plane: for S = float the returned alternate itself; for S = bf16 a
// scratch plane, beside which the BC launch writes the rounded alternate.
#include "bc.cuh"
#include "common.cuh"

using f2d::bf16;
using f2d::Grid;
using f2d::ld;

namespace {

// The advection term (v·∇)φ at cell (i, j) of one channel plane `phi`,
// carried by (u, w) at that cell (fluid2d_tpu/ops/advection.py). inv_adv
// is 1/dx (upwind) or 1/(6·dx) (KK). A NaN velocity compares false: upwind
// takes the backward difference, KK the positive-velocity coefficients.
template <bool kKK>
__device__ __forceinline__ float advect_term(const float* __restrict__ phi, const Grid& g, int i,
                                             int j, float u, float w, float inv_adv) {
  const float f0 = phi[(long long)i * g.Y + j];
  if constexpr (kKK) {
    const float p2x = phi[g.at(i + 2, j)], p1x = phi[g.at(i + 1, j)];
    const float m1x = phi[g.at(i - 1, j)], m2x = phi[g.at(i - 2, j)];
    const float sx = u < 0.0f ? -2.0f * p2x + 10.0f * p1x - 9.0f * f0 + 2.0f * m1x - 1.0f * m2x
                              : 1.0f * p2x - 2.0f * p1x + 9.0f * f0 - 10.0f * m1x + 2.0f * m2x;
    const float p2y = phi[g.at(i, j + 2)], p1y = phi[g.at(i, j + 1)];
    const float m1y = phi[g.at(i, j - 1)], m2y = phi[g.at(i, j - 2)];
    const float sy = w < 0.0f ? -2.0f * p2y + 10.0f * p1y - 9.0f * f0 + 2.0f * m1y - 1.0f * m2y
                              : 1.0f * p2y - 2.0f * p1y + 9.0f * f0 - 10.0f * m1y + 2.0f * m2y;
    const float a = sx * inv_adv;
    const float b = sy * inv_adv;
    return u * a + w * b;
  }
  const float dfx = u < 0.0f ? (phi[g.at(i + 1, j)] - f0) * inv_adv
                             : (f0 - phi[g.at(i - 1, j)]) * inv_adv;
  const float dfy = w < 0.0f ? (phi[g.at(i, j + 1)] - f0) * inv_adv
                             : (f0 - phi[g.at(i, j - 1)]) * inv_adv;
  const float ax = u * dfx;
  const float ay = w * dfy;
  return ax + ay;
}

struct MacConsts {
  float dt, inv_dx, inv_adv, inv_dx2, inv_re;  // as ops/cuda_phases.py rounds them
};

// v + dt·(−(v·∇)v − ∇p + ∇²v/Re) at fluid cells (fs/solver.py:79-107),
// v_alt elsewhere; blockIdx.z is the component.
template <bool kKK, typename S>
__global__ void mac_velocity_update_kernel(const float* __restrict__ v_bc,
                                           const S* __restrict__ p,
                                           const S* __restrict__ v_alt,
                                           const int8_t* __restrict__ fluid,
                                           S* __restrict__ out, Grid g, MacConsts c) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const int ch = blockIdx.z;
  const long long k = (long long)i * g.Y + j;
  const long long kc = ch * g.plane() + k;
  if (fluid[k] == 0) {
    f2d::st(out, kc, ld(v_alt, kc));
    return;
  }
  const float* f = v_bc + ch * g.plane();
  const float f0 = f[k];
  const float adv = advect_term<kKK>(f, g, i, j, v_bc[k], v_bc[g.plane() + k], c.inv_adv);
  const float gp = ch == 0 ? 0.5f * (ld(p, g.at(i + 1, j)) - ld(p, g.at(i - 1, j))) * c.inv_dx
                           : 0.5f * (ld(p, g.at(i, j + 1)) - ld(p, g.at(i, j - 1))) * c.inv_dx;
  const float lap = (f[g.at(i + 1, j)] - 2.0f * f0 + f[g.at(i - 1, j)]) * c.inv_dx2
                    + (f[g.at(i, j + 1)] - 2.0f * f0 + f[g.at(i, j - 1)]) * c.inv_dx2;
  const float rhs = -adv - gp + lap * c.inv_re;
  f2d::st(out, kc, f0 + c.dt * rhs);
}

// f_bc − dt·(vel·∇)f_bc at fluid cells (fs/solver.py:149-161), the old
// alternate elsewhere, then the [0, 1] clamp; blockIdx.z is the channel.
template <bool kKK, typename S>
__global__ void mac_dye_update_kernel(const float* __restrict__ d_bc,
                                      const S* __restrict__ dye_alt,
                                      const S* __restrict__ vel,
                                      const int8_t* __restrict__ fluid, S* __restrict__ out,
                                      Grid g, float dt, float inv_adv) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  const long long kc = blockIdx.z * g.plane() + k;
  float r;
  if (fluid[k] != 0) {
    const float* f = d_bc + blockIdx.z * g.plane();
    r = f[k] - dt * advect_term<kKK>(f, g, i, j, ld(vel, k), ld(vel, g.plane() + k), inv_adv);
  } else {
    r = ld(dye_alt, kc);
  }
  f2d::st(out, kc, fminf(fmaxf(r, 0.0f), 1.0f));
}

// The velocity phase; v_bc32 is the float BC'd field (v_bc itself for S = float).
template <typename S>
int mac_velocity_phase(const S* v, const S* p, const S* v_alt, const S* bc_const,
                       const int8_t* vbc_code, const int8_t* fluid8, S* v_out, S* v_bc,
                       float* v_bc32, Grid g, int kk, MacConsts c, cudaStream_t s) {
  const dim3 blocks = f2d::launch_blocks(g.X, g.Y, 2), threads = f2d::launch_threads();
  f2d::velocity_bc_kernel<S><<<blocks, threads, 0, s>>>(v, vbc_code, bc_const, v_bc32, v_bc, g);
  F2D_CHECK_LAUNCH();
  if (kk) {
    mac_velocity_update_kernel<true, S><<<blocks, threads, 0, s>>>(v_bc32, p, v_alt, fluid8,
                                                                   v_out, g, c);
  } else {
    mac_velocity_update_kernel<false, S><<<blocks, threads, 0, s>>>(v_bc32, p, v_alt, fluid8,
                                                                    v_out, g, c);
  }
  F2D_CHECK_LAUNCH();
  return 0;
}

// The dye phase; d_bc32 is the float BC'd dye (d_bc itself for S = float).
template <typename S>
int mac_dye_phase(const S* dye, const S* dye_alt, const S* vel, const S* bc_dye,
                  const int8_t* inflow8, const int8_t* fluid8, S* d_out, S* d_bc, float* d_bc32,
                  Grid g, int C, int kk, float dt, float inv_adv, cudaStream_t s) {
  const dim3 blocks = f2d::launch_blocks(g.X, g.Y, C), threads = f2d::launch_threads();
  f2d::dye_bc_kernel<S><<<blocks, threads, 0, s>>>(dye, inflow8, bc_dye, d_bc32, d_bc, g);
  F2D_CHECK_LAUNCH();
  if (kk) {
    mac_dye_update_kernel<true, S><<<blocks, threads, 0, s>>>(d_bc32, dye_alt, vel, fluid8, d_out,
                                                              g, dt, inv_adv);
  } else {
    mac_dye_update_kernel<false, S><<<blocks, threads, 0, s>>>(d_bc32, dye_alt, vel, fluid8,
                                                               d_out, g, dt, inv_adv);
  }
  F2D_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// v, v_alt, bc_const, v_out, v_bc: (2, X, Y); p: (X, Y). v_bc is the BC'd
// input velocity, the new alternate. kk selects the scheme (0 upwind).
extern "C" int f2d_mac_velocity_phase(const float* v, const float* p, const float* v_alt,
                                      const float* bc_const, const int8_t* vbc_code,
                                      const int8_t* fluid8, float* v_out, float* v_bc, int X,
                                      int Y, int kk, float dt, float inv_dx, float inv_adv,
                                      float inv_dx2, float inv_re, void* stream) {
  return mac_velocity_phase<float>(v, p, v_alt, bc_const, vbc_code, fluid8, v_out, v_bc, v_bc,
                                   Grid{X, Y}, kk, MacConsts{dt, inv_dx, inv_adv, inv_dx2, inv_re},
                                   static_cast<cudaStream_t>(stream));
}

// The same with bf16 fields; v_bc32: (2, X, Y) float scratch.
extern "C" int f2d_mac_velocity_phase_bf16(const bf16* v, const bf16* p, const bf16* v_alt,
                                           const bf16* bc_const, const int8_t* vbc_code,
                                           const int8_t* fluid8, bf16* v_out, bf16* v_bc,
                                           float* v_bc32, int X, int Y, int kk, float dt,
                                           float inv_dx, float inv_adv, float inv_dx2,
                                           float inv_re, void* stream) {
  return mac_velocity_phase<bf16>(v, p, v_alt, bc_const, vbc_code, fluid8, v_out, v_bc, v_bc32,
                                  Grid{X, Y}, kk, MacConsts{dt, inv_dx, inv_adv, inv_dx2, inv_re},
                                  static_cast<cudaStream_t>(stream));
}

// dye, dye_alt, bc_dye, d_out, d_bc: (C, X, Y); vel: (2, X, Y), the limited
// velocity. d_bc is the BC'd input dye, the new alternate (unclamped).
extern "C" int f2d_mac_dye_phase(const float* dye, const float* dye_alt, const float* vel,
                                 const float* bc_dye, const int8_t* inflow8,
                                 const int8_t* fluid8, float* d_out, float* d_bc, int X, int Y,
                                 int C, int kk, float dt, float inv_adv, void* stream) {
  return mac_dye_phase<float>(dye, dye_alt, vel, bc_dye, inflow8, fluid8, d_out, d_bc, d_bc,
                              Grid{X, Y}, C, kk, dt, inv_adv, static_cast<cudaStream_t>(stream));
}

// The same with bf16 fields; d_bc32: (C, X, Y) float scratch.
extern "C" int f2d_mac_dye_phase_bf16(const bf16* dye, const bf16* dye_alt, const bf16* vel,
                                      const bf16* bc_dye, const int8_t* inflow8,
                                      const int8_t* fluid8, bf16* d_out, bf16* d_bc,
                                      float* d_bc32, int X, int Y, int C, int kk, float dt,
                                      float inv_adv, void* stream) {
  return mac_dye_phase<bf16>(dye, dye_alt, vel, bc_dye, inflow8, fluid8, d_out, d_bc, d_bc32,
                             Grid{X, Y}, C, kk, dt, inv_adv, static_cast<cudaStream_t>(stream));
}
