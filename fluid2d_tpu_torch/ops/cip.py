"""CIP (Constrained Interpolation Profile) advection on whole tensors
(port of ``fluid2d_tpu/ops/cip.py``; reference ``fs/solver.py:207-332``).

The advected field ``f`` and its gradients ``fx, fy`` are ``(C, X, Y)``
(C=2 for velocity, C=3 for dye); the carrying velocity components
``u, w`` are ``(X, Y)`` and broadcast over channels. Reads that the
reference leaves undefined at the global border clamp to the edge, as in
the JAX package.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.stencil import diff2_x, diff2_y, diff_x, diff_y, shift_x, shift_y, sign

__all__ = [
    "cip_advect",
    "grad_of",
    "non_advection_velocity",
    "non_advection_diffusion",
    "non_advection_grad",
]


def grad_of(f, dx: float):
    """Central-difference gradients used to initialize CIP gradient fields
    (``fs/solver.py:207-211``)."""
    return diff_x(f, dx), diff_y(f, dx)


def non_advection_velocity(v, p, re: float, dt: float, dx: float):
    """CIP non-advection phase for velocity: pressure + diffusion
    (``fs/solver.py:229-240``). Full-grid candidate; callers mask to
    not-wall cells."""
    gp = torch.stack([diff_x(p, dx), diff_y(p, dx)])
    g = -gp + (diff2_sum(v, dx)) / re
    return v + g * dt


def non_advection_diffusion(f, re: float, dt: float, dx: float):
    """CIP non-advection phase for dye: diffusion only, same Re
    (``fs/solver.py:378-383``), in the reference's order
    ``f + (diffusion * dt)``."""
    return f + (diff2_sum(f, dx) / re) * dt


def diff2_sum(f, dx: float):
    """∇²f via the reference's paired second-derivative stencils
    (``fs/solver.py:263-265``)."""
    return diff2_x(f, dx) + diff2_y(f, dx)


def non_advection_grad(fx_cur, fy_cur, f_cur, f_new, dx: float):
    """Gradient update from the non-advection-phase *change* in f
    (``fs/solver.py:242-261``). Full-grid candidates; callers mask."""
    delta = f_new - f_cur
    fxn = fx_cur + (shift_x(delta, 1) - shift_x(delta, -1)) / (2.0 * dx)
    fyn = fy_cur + (shift_y(delta, 1) - shift_y(delta, -1)) / (2.0 * dx)
    return fxn, fyn


def _sel_x(arr, upwind_pos):
    """arr[i - i_s, j]: i_s=+1 (u ≥ 0) reads i-1; i_s=-1 (u < 0) reads i+1."""
    return torch.where(upwind_pos, shift_x(arr, -1), shift_x(arr, 1))


def _sel_y(arr, upwind_pos):
    return torch.where(upwind_pos, shift_y(arr, -1), shift_y(arr, 1))


def _sel_xy(arr, up_x, up_y):
    """arr[i - i_s, j - j_s] with BOTH signs taken at the center cell.

    Composing _sel_y(_sel_x(arr)) would be wrong: the inner selection
    would be evaluated at the y-shifted position, using that cell's
    upwind direction instead of the center's.
    """
    mm = shift_y(shift_x(arr, -1), -1)
    mp = shift_y(shift_x(arr, -1), 1)
    pm = shift_y(shift_x(arr, 1), -1)
    pp = shift_y(shift_x(arr, 1), 1)
    return torch.where(up_x, torch.where(up_y, mm, mp), torch.where(up_y, pm, pp))


def cip_advect(f, fx, fy, u, w, dt: float, dx: float):
    """Cubic CIP advection of (value, gradient) triplets
    (``fs/solver.py:282-332``), full-grid.

    Returns the advected ``(f, fx, fy)`` candidates; callers mask to the
    fluid domain.
    """
    i_s = sign(u)  # +1 when u ≥ 0 (sign(0)=+1, NaN→+1), else -1
    j_s = sign(w)
    # NaN velocity must select the i_s=+1 branch like sign() does.
    up_x = torch.logical_not(u < 0.0)
    up_y = torch.logical_not(w < 0.0)

    f_im = _sel_x(f, up_x)
    f_jm = _sel_y(f, up_y)
    f_imjm = _sel_xy(f, up_x, up_y)
    fx_im = _sel_x(fx, up_x)
    fx_jm = _sel_y(fx, up_y)
    fy_im = _sel_x(fy, up_x)
    fy_jm = _sel_y(fy, up_y)

    tmp1 = f - f_jm - f_im + f_imjm
    tmp2 = f_im - f
    tmp3 = f_jm - f

    i_s_denom = i_s * dx**3
    j_s_denom = j_s * dx**3

    a = (i_s * (fx_im + fx) * dx - 2.0 * (-tmp2)) / i_s_denom
    b = (j_s * (fy_jm + fy) * dx - 2.0 * (-tmp3)) / j_s_denom
    c = (-tmp1 - i_s * (fx_jm - fx) * dx) / j_s_denom
    d = (-tmp1 - j_s * (fy_im - fy) * dx) / i_s_denom
    e = (3.0 * tmp2 + i_s * (fx_im + 2.0 * fx) * dx) / dx**2
    f_c = (3.0 * tmp3 + j_s * (fy_jm + 2.0 * fy) * dx) / dx**2
    g = (-(fy_im - fy) + c * dx**2) / (i_s * dx)

    X = -u * dt
    Y = -w * dt

    fn = (
        ((a * X + c * Y + e) * X + g * Y + fx) * X
        + ((b * Y + d * X + f_c) * Y + fy) * Y
        + f
    )

    Fx = (3.0 * a * X + 2.0 * c * Y + 2.0 * e) * X + (d * Y + g) * Y + fx
    Fy = (3.0 * b * Y + 2.0 * d * X + 2.0 * f_c) * Y + (c * X + g) * X + fy

    dudx = diff_x(u, dx)
    dwdx = diff_x(w, dx)
    dudy = diff_y(u, dx)
    dwdy = diff_y(w, dx)
    fxn = Fx - dt * (Fx * dudx + Fy * dwdx) / 2.0
    fyn = Fy - dt * (Fx * dudy + Fy * dwdy) / 2.0
    return fn, fxn, fyn
