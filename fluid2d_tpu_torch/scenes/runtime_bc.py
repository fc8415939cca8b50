"""Runtime boundary-condition application (port of
``fluid2d_tpu/scenes/runtime_bc.py``): branch-free gathers from the
pre-BC tensor, driven by the static masks of :mod:`.compile`."""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.stencil import shift2, shift_x, shift_y, tmax

__all__ = ["velocity_bc", "pressure_bc", "dye_bc"]


def velocity_bc(v: torch.Tensor, scene) -> torch.Tensor:
    """Re-impose velocity BCs on (2, X, Y) velocity `v`
    (``fs/boundary_condition.py:16-39``).

    1. Ghost-velocity mirrors into second-layer wall cells (for the KK
       scheme's ±2 stencil): target ← −v[source two cells toward fluid].
    2. Inflow cells ← bc_const.
    3. Outflow cells: x-component ← max(v[i-1, j].x, 0.05) (no backflow;
       fmax semantics: NaN → 0.05). y-component unchanged.
    """
    t = scene.vbc_targets
    out = torch.where(t[0], -shift2(v, -2, 0), v)
    out = torch.where(t[1], -shift2(v, 2, 0), out)
    out = torch.where(t[2], -shift2(v, 0, -2), out)
    out = torch.where(t[3], -shift2(v, 0, 2), out)
    out = torch.where(scene.inflow, scene.bc_const, out)
    u_out = torch.where(scene.outflow, tmax(shift_x(v[0], -1), 0.05), out[0])
    return torch.stack([u_out, out[1]])


def pressure_bc(p: torch.Tensor, scene) -> torch.Tensor:
    """Re-impose pressure BCs on (X, Y) pressure `p`
    (``fs/boundary_condition.py:41-65``): Neumann copies/averages from
    adjacent fluid for walls, upstream copy for inflow, zero for outflow.
    Only ``scene.pbc_code`` is read.
    """
    code = scene.pbc_code
    px_m = shift_x(p, -1)  # p(i-1, j), clamp-to-edge like the reference's sample
    px_p = shift_x(p, 1)
    py_m = shift_y(p, -1)
    py_p = shift_y(p, 1)

    out = p
    out = torch.where(code == 1, px_m, out)
    out = torch.where(code == 2, px_p, out)
    out = torch.where(code == 3, py_m, out)
    out = torch.where(code == 4, py_p, out)
    out = torch.where(code == 5, (px_m + py_p) / 2.0, out)
    out = torch.where(code == 6, (px_p + py_p) / 2.0, out)
    out = torch.where(code == 7, (px_m + py_m) / 2.0, out)
    out = torch.where(code == 8, (px_p + py_m) / 2.0, out)
    out = torch.where(code == 9, px_p, out)
    out = torch.where(code == 10, 0.0, out)
    return out


def dye_bc(dye: torch.Tensor, scene) -> torch.Tensor:
    """Inflow cells take the scene's dye colors
    (``fs/boundary_condition.py:94-99``)."""
    return torch.where(scene.inflow, scene.bc_dye, dye)
