"""Pressure Poisson iteration operators, Jacobi and red-black SOR (port of
``fluid2d_tpu/ops/pressure.py``).

The reference's double-buffer dance has observable staleness semantics
that are reproduced exactly:

* Each iteration applies the pressure BC to the *current* buffer, then the
  sweeps write into the *alternate* buffer — whose non-swept cells (walls,
  inflow/outflow and the pre-sweep even-parity values for SOR; walls only
  for Jacobi) keep values from one iteration earlier. The buffers then swap.
* The even sweep reads the buffer it writes (Gauss-Seidel coloring,
  ``fs/pressure_updater.py:92-96``): even cells see the odd sweep's fresh
  neighbors but their *own* stale value in the relaxation term.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.stencil import shift_x, shift_y
from fluid2d_tpu_torch.scenes.runtime_bc import pressure_bc

__all__ = ["predict_p", "sor_pressure_iteration", "jacobi_pressure_iteration"]


def predict_p(p, u, w, dt: float, dx: float) -> torch.Tensor:
    """Jacobi/SOR pressure prediction (``fs/pressure_updater.py:24-38``).

    ¼·(4-neighbor sum) + nonlinear velocity-gradient source − divergence
    forcing, all with clamp-to-edge sampling.
    """
    sub_x_u = shift_x(u, 1) - shift_x(u, -1)  # Δx u
    sub_x_w = shift_x(w, 1) - shift_x(w, -1)  # Δx w
    sub_y_u = shift_y(u, 1) - shift_y(u, -1)  # Δy u
    sub_y_w = shift_y(w, 1) - shift_y(w, -1)  # Δy w

    # x·x, not x**2: JAX lowers **2 to one product, while PyTorch's pow on
    # the card need not round like it (the CUDA kernel multiplies too).
    return (
        0.25 * (shift_x(p, 1) + shift_x(p, -1) + shift_y(p, 1) + shift_y(p, -1))
        + (sub_x_u * sub_x_u + sub_y_w * sub_y_w + (sub_y_u * sub_x_w)) / 8.0
        - dx * (sub_x_u + sub_y_w) / (8 * dt)
    )


def sor_pressure_iteration(p_cur, p_alt, u, w, scene, omega: float, dt: float, dx: float):
    """One red-black SOR iteration with exact reference buffer semantics
    (``fs/pressure_updater.py:86-114``). `scene` needs ``pbc_code``,
    ``odd_fluid`` and ``even_fluid``.

    Returns the new ``(p_cur, p_alt)`` pair (post-swap order).
    """
    pc = pressure_bc(p_cur, scene)
    # Odd sweep: read BC'd current, write into alternate buffer.
    pn = torch.where(scene.odd_fluid, (1.0 - omega) * pc + omega * predict_p(pc, u, w, dt, dx), p_alt)
    # Even sweep: read AND write the same buffer (Gauss-Seidel coloring).
    pn = torch.where(scene.even_fluid, (1.0 - omega) * pn + omega * predict_p(pn, u, w, dt, dx), pn)
    return pn, pc


def jacobi_pressure_iteration(p_cur, p_alt, u, w, scene, dt: float, dx: float):
    """One Jacobi iteration (``fs/pressure_updater.py:42-66``): every
    not-wall cell of the alternate buffer takes the prediction from the
    BC'd current buffer. `scene` needs ``pbc_code`` and ``not_wall``.

    Returns the new ``(p_cur, p_alt)`` pair (post-swap order).
    """
    pc = pressure_bc(p_cur, scene)
    pn = torch.where(scene.not_wall, predict_p(pc, u, w, dt, dx), p_alt)
    return pn, pc
