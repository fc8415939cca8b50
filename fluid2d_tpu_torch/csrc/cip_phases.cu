// The CIP velocity phase and the CIP dye phase.
//
// Replace fluid2d_tpu/ops/pallas_phases.py:cip_velocity_phase_pallas (body
// _cip_velocity_body) and cip_dye_phase_pallas (body _cip_dye_body). The
// arithmetic is the port's eager path (the jnp branches of
// fluid2d_tpu/models/cip.py) operation for operation, rounded as PyTorch
// rounds it on the card (see common.cuh). Each phase cascades four stencils, and each
// stage is its own launch with its result in device memory, so every
// shifted read of a computed field clamps at the grid ends exactly as the
// jnp path does (what the Pallas kernels rebuild with _reclamp):
//   1. BC                 state      -> f_bc   (scratch)
//   2. non-advection      f_bc       -> f_na   at not-wall cells, alt elsewhere
//   3. gradient update    f_na − f_bc -> g_na  at not-wall cells, alt elsewhere
//   4. CIP advection      (f_na, g_na) by the carrying velocity at fluid
//                         cells; f_bc and the pre-phase gradients elsewhere
// The velocity phase carries by its own f_na; the dye phase by the limited
// velocity it is given, and clamps the advected dye to [0, 1]. The BC
// kernels are those of bc.cuh, shared with the MAC phases.
#include "bc.cuh"
#include "cip_advect.cuh"
#include "common.cuh"

using f2d::CipConsts;
using f2d::Grid;

namespace {

// f_bc + (−∇p + ∇²f/Re)·dt (velocity, p given) or f_bc + (∇²f/Re)·dt
// (dye, p null) at not-wall cells; the alternate buffer elsewhere.
__global__ void non_advection_kernel(const float* __restrict__ f_bc,
                                     const float* __restrict__ p,
                                     const float* __restrict__ alt,
                                     const int8_t* __restrict__ not_wall,
                                     float* __restrict__ out, Grid g, CipConsts c) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const int ch = blockIdx.z;
  const long long k = (long long)i * g.Y + j;
  const long long kc = ch * g.plane() + k;
  if (not_wall[k] == 0) {
    out[kc] = alt[kc];
    return;
  }
  const float* f = f_bc + ch * g.plane();
  const float f0 = f[k];
  const float lap = (f[g.at(i + 1, j)] - 2.0f * f0 + f[g.at(i - 1, j)]) * c.inv_dx2
                    + (f[g.at(i, j + 1)] - 2.0f * f0 + f[g.at(i, j - 1)]) * c.inv_dx2;
  if (p != nullptr) {
    const float gp = ch == 0 ? 0.5f * (p[g.at(i + 1, j)] - p[g.at(i - 1, j)]) * c.inv_dx
                             : 0.5f * (p[g.at(i, j + 1)] - p[g.at(i, j - 1)]) * c.inv_dx;
    const float rhs = -gp + lap * c.inv_re;
    out[kc] = f0 + rhs * c.dt;
  } else {
    out[kc] = f0 + (lap * c.inv_re) * c.dt;
  }
}

// Gradient update from the non-advection change Δ = f_na − f_bc
// (fs/solver.py:242-261) at not-wall cells; the alternate buffers elsewhere.
__global__ void grad_update_kernel(const float* __restrict__ f_na,
                                   const float* __restrict__ f_bc,
                                   const float* __restrict__ gx, const float* __restrict__ gx_alt,
                                   const float* __restrict__ gy, const float* __restrict__ gy_alt,
                                   const int8_t* __restrict__ not_wall,
                                   float* __restrict__ gx_out, float* __restrict__ gy_out,
                                   Grid g, float inv_two_dx) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long off = blockIdx.z * g.plane();
  const long long k = (long long)i * g.Y + j;
  if (not_wall[k] == 0) {
    gx_out[off + k] = gx_alt[off + k];
    gy_out[off + k] = gy_alt[off + k];
    return;
  }
  const float* fn = f_na + off;
  const float* fb = f_bc + off;
  const long long xp = g.at(i + 1, j), xm = g.at(i - 1, j);
  const long long yp = g.at(i, j + 1), ym = g.at(i, j - 1);
  gx_out[off + k] = gx[off + k] + ((fn[xp] - fb[xp]) - (fn[xm] - fb[xm])) * inv_two_dx;
  gy_out[off + k] = gy[off + k] + ((fn[yp] - fb[yp]) - (fn[ym] - fb[ym])) * inv_two_dx;
}

// CIP advection at fluid cells, the kept values elsewhere; clamp01 applies
// the dye's [0, 1] clamp (fminf/fmaxf: NaN → 0) to the value output.
__global__ void advect_kernel(const float* __restrict__ f_na, const float* __restrict__ gx_na,
                              const float* __restrict__ gy_na, const float* __restrict__ u,
                              const float* __restrict__ w, const int8_t* __restrict__ fluid,
                              const float* __restrict__ keep_f, const float* __restrict__ keep_gx,
                              const float* __restrict__ keep_gy, float* __restrict__ out_f,
                              float* __restrict__ out_gx, float* __restrict__ out_gy, Grid g,
                              CipConsts consts, int clamp01) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long off = blockIdx.z * g.plane();
  const long long k = (long long)i * g.Y + j;
  f2d::CipCell r;
  if (fluid[k] != 0) {
    r = f2d::cip_advect_cell(f_na + off, gx_na + off, gy_na + off, u, w, g, i, j, consts);
  } else {
    r.f = keep_f[off + k];
    r.fx = keep_gx[off + k];
    r.fy = keep_gy[off + k];
  }
  out_f[off + k] = clamp01 ? fminf(fmaxf(r.f, 0.0f), 1.0f) : r.f;
  out_gx[off + k] = r.fx;
  out_gy[off + k] = r.fy;
}

}  // namespace

// All fields (2, X, Y) except p (X, Y); v_bc is scratch. Outputs: the
// advected (v, vx, vy) and the new alternates (v_na, vx_na, vy_na). The
// grid constants are those of CipConsts, in its order.
extern "C" int f2d_cip_velocity_phase(
    const float* v, const float* p, const float* v_alt, const float* vx, const float* vx_alt,
    const float* vy, const float* vy_alt, const float* bc_const, const int8_t* vbc_code,
    const int8_t* not_wall8, const int8_t* fluid8, float* v_bc, float* v_out, float* vx_out,
    float* vy_out, float* v_na, float* vx_na, float* vy_na, int X, int Y, float dt, float dx,
    float dx2, float dx3, float inv_dx, float inv_dx2, float inv_re, float inv_two_dx,
    void* stream) {
  const Grid g{X, Y};
  const CipConsts c{dt, dx, dx2, dx3, inv_dx, inv_dx2, inv_re, inv_two_dx};
  const long long plane = (long long)X * Y;
  const dim3 blocks = f2d::launch_blocks(X, Y, 2), threads = f2d::launch_threads();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  f2d::velocity_bc_kernel<<<blocks, threads, 0, s>>>(v, vbc_code, bc_const, v_bc, g);
  F2D_CHECK_LAUNCH();
  non_advection_kernel<<<blocks, threads, 0, s>>>(v_bc, p, v_alt, not_wall8, v_na, g, c);
  F2D_CHECK_LAUNCH();
  grad_update_kernel<<<blocks, threads, 0, s>>>(v_na, v_bc, vx, vx_alt, vy, vy_alt, not_wall8,
                                                vx_na, vy_na, g, inv_two_dx);
  F2D_CHECK_LAUNCH();
  advect_kernel<<<blocks, threads, 0, s>>>(v_na, vx_na, vy_na, v_na, v_na + plane, fluid8, v_bc,
                                           vx, vy, v_out, vx_out, vy_out, g, c, 0);
  F2D_CHECK_LAUNCH();
  return 0;
}

// Dye fields (3, X, Y), vel (2, X, Y); d_bc is scratch. Constants as above.
extern "C" int f2d_cip_dye_phase(
    const float* dye, const float* dye_alt, const float* dyex, const float* dyex_alt,
    const float* dyey, const float* dyey_alt, const float* vel, const float* bc_dye,
    const int8_t* inflow8, const int8_t* not_wall8, const int8_t* fluid8, float* d_bc,
    float* d_out, float* dx_out, float* dy_out, float* d_na, float* dx_na, float* dy_na, int X,
    int Y, float dt, float dx, float dx2, float dx3, float inv_dx, float inv_dx2, float inv_re,
    float inv_two_dx, void* stream) {
  const Grid g{X, Y};
  const CipConsts c{dt, dx, dx2, dx3, inv_dx, inv_dx2, inv_re, inv_two_dx};
  const long long plane = (long long)X * Y;
  const dim3 blocks = f2d::launch_blocks(X, Y, 3), threads = f2d::launch_threads();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  f2d::dye_bc_kernel<<<blocks, threads, 0, s>>>(dye, inflow8, bc_dye, d_bc, g);
  F2D_CHECK_LAUNCH();
  non_advection_kernel<<<blocks, threads, 0, s>>>(d_bc, nullptr, dye_alt, not_wall8, d_na, g, c);
  F2D_CHECK_LAUNCH();
  grad_update_kernel<<<blocks, threads, 0, s>>>(d_na, d_bc, dyex, dyex_alt, dyey, dyey_alt,
                                                not_wall8, dx_na, dy_na, g, inv_two_dx);
  F2D_CHECK_LAUNCH();
  advect_kernel<<<blocks, threads, 0, s>>>(d_na, dx_na, dy_na, vel, vel + plane, fluid8, d_bc,
                                           dyex, dyey, d_out, dx_out, dy_out, g, c, 1);
  F2D_CHECK_LAUNCH();
  return 0;
}
