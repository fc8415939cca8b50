"""Vorticity confinement (Fedkiw-style) on whole tensors (port of
``fluid2d_tpu/ops/vorticity.py``). Notes:

* Non-fluid cells carry zero vorticity (the reference's persistent fields
  are written at fluid cells only and start at zero).
* ``∇‖ω‖ / |∇‖ω‖|`` is unguarded on purpose (``fs/vorticity_confinement.py:49``):
  a zero gradient gives NaN, which the fmin/fmax clamp turns into +0.1
  (docs/PARITY.md §4).
* ``apply_confinement`` returns the post-swap pair (``:57-59``).
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.stencil import diff_x, diff_y, tmax, tmin

__all__ = ["confinement_force", "apply_confinement"]


def confinement_force(v, fluid, dx: float) -> torch.Tensor:
    """Clamped confinement force field, shape (2, X, Y)."""
    curl = diff_x(v[1], dx) - diff_y(v[0], dx)
    vorticity = torch.where(fluid, curl, 0.0)
    vort_abs = torch.where(fluid, torch.abs(curl), 0.0)

    gx = diff_x(vort_abs, dx)
    gy = diff_y(vort_abs, dx)
    norm = torch.sqrt(gx * gx + gy * gy)
    nx = gx / norm  # unguarded on purpose: 0/0 → NaN, clamped below
    ny = gy / norm
    fx = ny * vorticity
    fy = -nx * vorticity
    fx = tmax(tmin(fx, 0.1), -0.1)
    fy = tmax(tmin(fy, 0.1), -0.1)
    return torch.stack([fx, fy])


def apply_confinement(v_cur, v_alt, fluid, dt: float, weight: float, dx: float):
    """v_next = v_cur + dt·ε·f_conf at fluid cells (stale elsewhere), then
    swap. Returns the post-swap ``(v_cur, v_alt)`` pair."""
    force = confinement_force(v_cur, fluid, dx)
    vn = torch.where(fluid, v_cur + dt * weight * force, v_alt)
    return vn, v_cur
