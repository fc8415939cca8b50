// Cubic CIP advection of one cell's (value, ∂x, ∂y) triplet.
//
// The counterpart of fluid2d_tpu/ops/pallas_stencil.py:cip_advect_window_expr
// and cip_velocity_ctx, shared by the fused velocity and dye phase kernels
// and the standalone advection (f2d_cip_advect, cip_phases.cu). The
// arithmetic is the port's eager ops/cip.py:cip_advect (reference
// fs/solver.py:282-332) operation for operation, rounded as PyTorch rounds
// it on the card (common.cuh). Both upwind masks are
// evaluated at the centre cell, including for the diagonal term
// (pallas_stencil.py:856-863, ops/cip.py:_sel_xy).
#pragma once

#include "common.cuh"

namespace f2d {

// Grid constants as the eager path rounds them: dx2 = dx**2 and dx3 = dx**3
// rounded once from double; inv_* = 1/divisor in double, rounded once to
// float (PyTorch's CUDA division by a Python scalar multiplies by that).
struct CipConsts {
  float dt, dx, dx2, dx3, inv_dx, inv_dx2, inv_re, inv_two_dx;
};

struct CipCell {
  float f, fx, fy;
};

// f, fx, fy: one channel's value and gradients; u, w: the carrying
// velocity's two planes. Each is a cell accessor (common.cuh): here a Window
// of values in shared memory (the phases and the standalone advection).
template <typename FA, typename GA, typename VA>
__device__ __forceinline__ CipCell cip_advect_cell(const FA& f, const GA& fx, const GA& fy,
                                                   const VA& u, const VA& w, int i, int j,
                                                   const CipConsts& c) {
  const float uc = u(i, j), wc = w(i, j);
  // NaN compares false: a NaN velocity takes the +1 branch, like sign().
  const bool up_x = !(uc < 0.0f);
  const bool up_y = !(wc < 0.0f);
  const float i_s = up_x ? 1.0f : -1.0f;
  const float j_s = up_y ? 1.0f : -1.0f;
  const int iu = up_x ? i - 1 : i + 1;  // upwind row
  const int ju = up_y ? j - 1 : j + 1;  // upwind column

  const float f0 = f(i, j), f_im = f(iu, j), f_jm = f(i, ju), f_imjm = f(iu, ju);
  const float fx0 = fx(i, j), fx_im = fx(iu, j), fx_jm = fx(i, ju);
  const float fy0 = fy(i, j), fy_im = fy(iu, j), fy_jm = fy(i, ju);

  const float tmp1 = f0 - f_jm - f_im + f_imjm;
  const float tmp2 = f_im - f0;
  const float tmp3 = f_jm - f0;

  const float dx = c.dx, dx2 = c.dx2;
  const float i_s_denom = i_s * c.dx3;
  const float j_s_denom = j_s * c.dx3;

  const float a = (i_s * (fx_im + fx0) * dx - 2.0f * (-tmp2)) / i_s_denom;
  const float b = (j_s * (fy_jm + fy0) * dx - 2.0f * (-tmp3)) / j_s_denom;
  const float cc = (-tmp1 - i_s * (fx_jm - fx0) * dx) / j_s_denom;
  const float d = (-tmp1 - j_s * (fy_im - fy0) * dx) / i_s_denom;
  const float e = (3.0f * tmp2 + i_s * (fx_im + 2.0f * fx0) * dx) * c.inv_dx2;
  const float f_c = (3.0f * tmp3 + j_s * (fy_jm + 2.0f * fy0) * dx) * c.inv_dx2;
  const float gg = (-(fy_im - fy0) + cc * dx2) / (i_s * dx);

  const float X = -uc * c.dt;
  const float Y = -wc * c.dt;

  CipCell out;
  out.f = ((a * X + cc * Y + e) * X + gg * Y + fx0) * X + ((b * Y + d * X + f_c) * Y + fy0) * Y + f0;
  const float Fx = (3.0f * a * X + 2.0f * cc * Y + 2.0f * e) * X + (d * Y + gg) * Y + fx0;
  const float Fy = (3.0f * b * Y + 2.0f * d * X + 2.0f * f_c) * Y + (cc * X + gg) * X + fy0;

  const float dudx = 0.5f * (u(i + 1, j) - u(i - 1, j)) * c.inv_dx;
  const float dwdx = 0.5f * (w(i + 1, j) - w(i - 1, j)) * c.inv_dx;
  const float dudy = 0.5f * (u(i, j + 1) - u(i, j - 1)) * c.inv_dx;
  const float dwdy = 0.5f * (w(i, j + 1) - w(i, j - 1)) * c.inv_dx;
  out.fx = Fx - c.dt * (Fx * dudx + Fy * dwdx) * 0.5f;
  out.fy = Fy - c.dt * (Fx * dudy + Fy * dwdy) * 0.5f;
  return out;
}

}  // namespace f2d
