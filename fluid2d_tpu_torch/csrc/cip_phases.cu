// The CIP velocity phase, the CIP dye phase and the standalone CIP advection.
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
//
// Storage type S (common.cuh): the state's planes, the scene's constants and
// the six outputs are S; f_bc and the three f_na planes, which later launches
// read, are float. For S = float the f_na planes are the alternate outputs
// themselves; for S = bf16 they are scratch, and stages 2 and 3 write the
// rounded alternates beside them.
#include "bc.cuh"
#include "cip_advect.cuh"
#include "common.cuh"

using f2d::bf16;
using f2d::CipConsts;
using f2d::Grid;
using f2d::ld;

namespace {

// f_bc + (−∇p + ∇²f/Re)·dt (velocity, p given) or f_bc + (∇²f/Re)·dt
// (dye, p null) at not-wall cells; the alternate buffer elsewhere.
template <typename S>
__global__ void non_advection_kernel(const float* __restrict__ f_bc, const S* __restrict__ p,
                                     const S* __restrict__ alt,
                                     const int8_t* __restrict__ not_wall,
                                     float* __restrict__ out, S* __restrict__ out_s, Grid g,
                                     CipConsts c) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const int ch = blockIdx.z;
  const long long k = (long long)i * g.Y + j;
  const long long kc = ch * g.plane() + k;
  if (not_wall[k] == 0) {
    f2d::st2(out, out_s, kc, ld(alt, kc));
    return;
  }
  const float* f = f_bc + ch * g.plane();
  const float f0 = f[k];
  const float lap = (f[g.at(i + 1, j)] - 2.0f * f0 + f[g.at(i - 1, j)]) * c.inv_dx2
                    + (f[g.at(i, j + 1)] - 2.0f * f0 + f[g.at(i, j - 1)]) * c.inv_dx2;
  if (p != nullptr) {
    const float gp = ch == 0 ? 0.5f * (ld(p, g.at(i + 1, j)) - ld(p, g.at(i - 1, j))) * c.inv_dx
                             : 0.5f * (ld(p, g.at(i, j + 1)) - ld(p, g.at(i, j - 1))) * c.inv_dx;
    const float rhs = -gp + lap * c.inv_re;
    f2d::st2(out, out_s, kc, f0 + rhs * c.dt);
  } else {
    f2d::st2(out, out_s, kc, f0 + (lap * c.inv_re) * c.dt);
  }
}

// Gradient update from the non-advection change Δ = f_na − f_bc
// (fs/solver.py:242-261) at not-wall cells; the alternate buffers elsewhere.
template <typename S>
__global__ void grad_update_kernel(const float* __restrict__ f_na,
                                   const float* __restrict__ f_bc,
                                   const S* __restrict__ gx, const S* __restrict__ gx_alt,
                                   const S* __restrict__ gy, const S* __restrict__ gy_alt,
                                   const int8_t* __restrict__ not_wall,
                                   float* __restrict__ gx_out, float* __restrict__ gy_out,
                                   S* __restrict__ gx_out_s, S* __restrict__ gy_out_s, Grid g,
                                   float inv_two_dx) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long off = blockIdx.z * g.plane();
  const long long k = (long long)i * g.Y + j;
  if (not_wall[k] == 0) {
    f2d::st2(gx_out, gx_out_s, off + k, ld(gx_alt, off + k));
    f2d::st2(gy_out, gy_out_s, off + k, ld(gy_alt, off + k));
    return;
  }
  const float* fn = f_na + off;
  const float* fb = f_bc + off;
  const long long xp = g.at(i + 1, j), xm = g.at(i - 1, j);
  const long long yp = g.at(i, j + 1), ym = g.at(i, j - 1);
  f2d::st2(gx_out, gx_out_s, off + k,
           ld(gx, off + k) + ((fn[xp] - fb[xp]) - (fn[xm] - fb[xm])) * inv_two_dx);
  f2d::st2(gy_out, gy_out_s, off + k,
           ld(gy, off + k) + ((fn[yp] - fb[yp]) - (fn[ym] - fb[ym])) * inv_two_dx);
}

// CIP advection at fluid cells, the kept values elsewhere; clamp01 applies
// the dye's [0, 1] clamp (fminf/fmaxf: NaN → 0) to the value output. The
// carrying velocity is of storage type V; the advected planes and the kept
// value plane of type F: float in the phases (stage results), the storage
// type in the standalone advection (f2d_cip_advect).
template <typename S, typename V, typename F>
__global__ void advect_kernel(const F* __restrict__ f_na, const F* __restrict__ gx_na,
                              const F* __restrict__ gy_na, const V* __restrict__ u,
                              const V* __restrict__ w, const int8_t* __restrict__ fluid,
                              const F* __restrict__ keep_f, const S* __restrict__ keep_gx,
                              const S* __restrict__ keep_gy, S* __restrict__ out_f,
                              S* __restrict__ out_gx, S* __restrict__ out_gy, Grid g,
                              CipConsts consts, int clamp01) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long off = blockIdx.z * g.plane();
  const long long k = (long long)i * g.Y + j;
  f2d::CipCell r;
  if (fluid[k] != 0) {
    r = f2d::cip_advect_cell(f_na + off, gx_na + off, gy_na + off, u, w, g, i, j, consts);
  } else {
    r.f = ld(keep_f, off + k);
    r.fx = ld(keep_gx, off + k);
    r.fy = ld(keep_gy, off + k);
  }
  f2d::st(out_f, off + k, clamp01 ? fminf(fmaxf(r.f, 0.0f), 1.0f) : r.f);
  f2d::st(out_gx, off + k, r.fx);
  f2d::st(out_gy, off + k, r.fy);
}

// The velocity phase. v_na32, vx_na32, vy_na32: the float f_na planes
// (for S = float, v_na, vx_na, vy_na themselves).
template <typename S>
int cip_velocity_phase(const S* v, const S* p, const S* v_alt, const S* vx, const S* vx_alt,
                       const S* vy, const S* vy_alt, const S* bc_const, const int8_t* vbc_code,
                       const int8_t* not_wall8, const int8_t* fluid8, float* v_bc, S* v_out,
                       S* vx_out, S* vy_out, S* v_na, S* vx_na, S* vy_na, float* v_na32,
                       float* vx_na32, float* vy_na32, Grid g, CipConsts c, float inv_two_dx,
                       cudaStream_t s) {
  const long long plane = g.plane();
  const dim3 blocks = f2d::launch_blocks(g.X, g.Y, 2), threads = f2d::launch_threads();
  f2d::velocity_bc_kernel<S><<<blocks, threads, 0, s>>>(v, vbc_code, bc_const, v_bc, nullptr, g);
  F2D_CHECK_LAUNCH();
  non_advection_kernel<S><<<blocks, threads, 0, s>>>(v_bc, p, v_alt, not_wall8, v_na32, v_na, g,
                                                     c);
  F2D_CHECK_LAUNCH();
  grad_update_kernel<S><<<blocks, threads, 0, s>>>(v_na32, v_bc, vx, vx_alt, vy, vy_alt,
                                                   not_wall8, vx_na32, vy_na32, vx_na, vy_na, g,
                                                   inv_two_dx);
  F2D_CHECK_LAUNCH();
  advect_kernel<S, float, float><<<blocks, threads, 0, s>>>(v_na32, vx_na32, vy_na32, v_na32,
                                                            v_na32 + plane, fluid8, v_bc, vx, vy,
                                                            v_out, vx_out, vy_out, g, c, 0);
  F2D_CHECK_LAUNCH();
  return 0;
}

// The dye phase; d_na32, dx_na32, dy_na32 as above.
template <typename S>
int cip_dye_phase(const S* dye, const S* dye_alt, const S* dyex, const S* dyex_alt,
                  const S* dyey, const S* dyey_alt, const S* vel, const S* bc_dye,
                  const int8_t* inflow8, const int8_t* not_wall8, const int8_t* fluid8,
                  float* d_bc, S* d_out, S* dx_out, S* dy_out, S* d_na, S* dx_na, S* dy_na,
                  float* d_na32, float* dx_na32, float* dy_na32, Grid g, CipConsts c,
                  float inv_two_dx, cudaStream_t s) {
  const long long plane = g.plane();
  const dim3 blocks = f2d::launch_blocks(g.X, g.Y, 3), threads = f2d::launch_threads();
  f2d::dye_bc_kernel<S><<<blocks, threads, 0, s>>>(dye, inflow8, bc_dye, d_bc, nullptr, g);
  F2D_CHECK_LAUNCH();
  non_advection_kernel<S><<<blocks, threads, 0, s>>>(d_bc, nullptr, dye_alt, not_wall8, d_na32,
                                                     d_na, g, c);
  F2D_CHECK_LAUNCH();
  grad_update_kernel<S><<<blocks, threads, 0, s>>>(d_na32, d_bc, dyex, dyex_alt, dyey, dyey_alt,
                                                   not_wall8, dx_na32, dy_na32, dx_na, dy_na, g,
                                                   inv_two_dx);
  F2D_CHECK_LAUNCH();
  advect_kernel<S, S, float><<<blocks, threads, 0, s>>>(d_na32, dx_na32, dy_na32, vel,
                                                        vel + plane, fluid8, d_bc, dyex, dyey,
                                                        d_out, dx_out, dy_out, g, c, 1);
  F2D_CHECK_LAUNCH();
  return 0;
}

// Standalone CIP advection (C1): every plane of storage type S, widened on
// load; each output rounded once.
template <typename S>
int cip_advect(const void* f, const void* fx, const void* fy, const void* u, const void* w,
               const void* alt_f, const void* alt_fx, const void* alt_fy, const int8_t* fluid8,
               void* out_f, void* out_fx, void* out_fy, Grid g, int C, CipConsts c,
               cudaStream_t s) {
  auto in = [](const void* p) { return static_cast<const S*>(p); };
  auto out = [](void* p) { return static_cast<S*>(p); };
  advect_kernel<S, S, S><<<f2d::launch_blocks(g.X, g.Y, C), f2d::launch_threads(), 0, s>>>(
      in(f), in(fx), in(fy), in(u), in(w), fluid8, in(alt_f), in(alt_fx), in(alt_fy),
      out(out_f), out(out_fx), out(out_fy), g, c, 0);
  F2D_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// Standalone CIP advection (replaces fluid2d_tpu/ops/pallas_stencil.py:
// cip_advect_pallas): where(fluid, cip_advect(f, fx, fy, u, w), alt) per
// output. f, fx, fy, alt_f, alt_fx, alt_fy and the three outputs are
// (C, X, Y); u and w (X, Y) planes: the carrying velocity's two planes, or
// f's first two when the velocity advects itself (the read-only pointers may
// alias; no output aliases an input, the wrapper checks). Every field is
// stored as bf16 when bf16_storage != 0, else as float; fluid8 (X, Y) int8.
// Constants: dt, dx, dx², dx³, 1/dx, 1/dx², rounded as CipConsts says.
extern "C" int f2d_cip_advect(const void* f, const void* fx, const void* fy, const void* u,
                              const void* w, const void* alt_f, const void* alt_fx,
                              const void* alt_fy, const int8_t* fluid8, void* out_f, void* out_fx,
                              void* out_fy, int X, int Y, int C, int bf16_storage, float dt,
                              float dx, float dx2, float dx3, float inv_dx, float inv_dx2,
                              void* stream) {
  const CipConsts c{dt, dx, dx2, dx3, inv_dx, inv_dx2, 0.0f, 0.0f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_storage) {
    return cip_advect<bf16>(f, fx, fy, u, w, alt_f, alt_fx, alt_fy, fluid8, out_f, out_fx, out_fy,
                            Grid{X, Y}, C, c, s);
  }
  return cip_advect<float>(f, fx, fy, u, w, alt_f, alt_fx, alt_fy, fluid8, out_f, out_fx, out_fy,
                           Grid{X, Y}, C, c, s);
}

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
  return cip_velocity_phase<float>(
      v, p, v_alt, vx, vx_alt, vy, vy_alt, bc_const, vbc_code, not_wall8, fluid8, v_bc, v_out,
      vx_out, vy_out, v_na, vx_na, vy_na, v_na, vx_na, vy_na, Grid{X, Y},
      CipConsts{dt, dx, dx2, dx3, inv_dx, inv_dx2, inv_re, inv_two_dx}, inv_two_dx,
      static_cast<cudaStream_t>(stream));
}

// The same with bf16 fields; v_na32, vx_na32, vy_na32: (2, X, Y) float scratch.
extern "C" int f2d_cip_velocity_phase_bf16(
    const bf16* v, const bf16* p, const bf16* v_alt, const bf16* vx, const bf16* vx_alt,
    const bf16* vy, const bf16* vy_alt, const bf16* bc_const, const int8_t* vbc_code,
    const int8_t* not_wall8, const int8_t* fluid8, float* v_bc, bf16* v_out, bf16* vx_out,
    bf16* vy_out, bf16* v_na, bf16* vx_na, bf16* vy_na, float* v_na32, float* vx_na32,
    float* vy_na32, int X, int Y, float dt, float dx, float dx2, float dx3, float inv_dx,
    float inv_dx2, float inv_re, float inv_two_dx, void* stream) {
  return cip_velocity_phase<bf16>(
      v, p, v_alt, vx, vx_alt, vy, vy_alt, bc_const, vbc_code, not_wall8, fluid8, v_bc, v_out,
      vx_out, vy_out, v_na, vx_na, vy_na, v_na32, vx_na32, vy_na32, Grid{X, Y},
      CipConsts{dt, dx, dx2, dx3, inv_dx, inv_dx2, inv_re, inv_two_dx}, inv_two_dx,
      static_cast<cudaStream_t>(stream));
}

// Dye fields (3, X, Y), vel (2, X, Y); d_bc is scratch. Constants as above.
extern "C" int f2d_cip_dye_phase(
    const float* dye, const float* dye_alt, const float* dyex, const float* dyex_alt,
    const float* dyey, const float* dyey_alt, const float* vel, const float* bc_dye,
    const int8_t* inflow8, const int8_t* not_wall8, const int8_t* fluid8, float* d_bc,
    float* d_out, float* dx_out, float* dy_out, float* d_na, float* dx_na, float* dy_na, int X,
    int Y, float dt, float dx, float dx2, float dx3, float inv_dx, float inv_dx2, float inv_re,
    float inv_two_dx, void* stream) {
  return cip_dye_phase<float>(
      dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, vel, bc_dye, inflow8, not_wall8, fluid8,
      d_bc, d_out, dx_out, dy_out, d_na, dx_na, dy_na, d_na, dx_na, dy_na, Grid{X, Y},
      CipConsts{dt, dx, dx2, dx3, inv_dx, inv_dx2, inv_re, inv_two_dx}, inv_two_dx,
      static_cast<cudaStream_t>(stream));
}

// The same with bf16 fields; d_na32, dx_na32, dy_na32: (3, X, Y) float scratch.
extern "C" int f2d_cip_dye_phase_bf16(
    const bf16* dye, const bf16* dye_alt, const bf16* dyex, const bf16* dyex_alt,
    const bf16* dyey, const bf16* dyey_alt, const bf16* vel, const bf16* bc_dye,
    const int8_t* inflow8, const int8_t* not_wall8, const int8_t* fluid8, float* d_bc,
    bf16* d_out, bf16* dx_out, bf16* dy_out, bf16* d_na, bf16* dx_na, bf16* dy_na,
    float* d_na32, float* dx_na32, float* dy_na32, int X, int Y, float dt, float dx, float dx2,
    float dx3, float inv_dx, float inv_dx2, float inv_re, float inv_two_dx, void* stream) {
  return cip_dye_phase<bf16>(
      dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, vel, bc_dye, inflow8, not_wall8, fluid8,
      d_bc, d_out, dx_out, dy_out, d_na, dx_na, dy_na, d_na32, dx_na32, dy_na32, Grid{X, Y},
      CipConsts{dt, dx, dx2, dx3, inv_dx, inv_dx2, inv_re, inv_two_dx}, inv_two_dx,
      static_cast<cudaStream_t>(stream));
}
