"""Full-array advection schemes: central, first-order upwind and
Kawamura-Kuwahara (port of ``fluid2d_tpu/ops/advection.py``; reference
``fs/advection.py:7-60``).

Each function returns the advection term ``(v·∇)φ`` for the whole grid.
Velocity components ``u, w`` are ``(X, Y)``; the advected field ``phi``
is ``(..., X, Y)`` and its leading channel axes broadcast. Upwinding is a
``torch.where`` between pre-shifted differences, in the JAX package's
association order. CIP advection lives in :mod:`.cip`.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.stencil import (
    bdiff_x,
    bdiff_y,
    diff_x,
    diff_y,
    fdiff_x,
    fdiff_y,
    shift_x,
    shift_y,
)

__all__ = ["advect_central", "advect_upwind", "advect_kk"]


def advect_central(u, w, phi, dx: float):
    """Central differencing (``fs/advection.py:7-9``; no scheme of the
    reference CLI uses it, but it is part of its library surface)."""
    return u * diff_x(phi, dx) + w * diff_y(phi, dx)


def advect_upwind(u, w, phi, dx: float):
    """First-order upwind differencing (``fs/advection.py:13-24``): the
    forward difference where the velocity is negative, the backward one
    otherwise. A NaN velocity compares false and takes the backward branch."""
    ax = u * torch.where(u < 0.0, fdiff_x(phi, dx), bdiff_x(phi, dx))
    ay = w * torch.where(w < 0.0, fdiff_y(phi, dx), bdiff_y(phi, dx))
    return ax + ay


def advect_kk(u, w, phi, dx: float):
    """Kawamura-Kuwahara 5-point upwind-biased scheme
    (``fs/advection.py:28-60``): coefficients [-2, 10, -9, 2, -1] on
    [φ(+2), φ(+1), φ(0), φ(-1), φ(-2)] where the velocity is negative, the
    reversed, sign-flipped set otherwise; denominator 6·dx."""
    p2x, p1x = shift_x(phi, 2), shift_x(phi, 1)
    m1x, m2x = shift_x(phi, -1), shift_x(phi, -2)
    neg_x = -2.0 * p2x + 10.0 * p1x - 9.0 * phi + 2.0 * m1x - 1.0 * m2x
    pos_x = 1.0 * p2x - 2.0 * p1x + 9.0 * phi - 10.0 * m1x + 2.0 * m2x
    a = torch.where(u < 0.0, neg_x, pos_x) / (6.0 * dx)

    p2y, p1y = shift_y(phi, 2), shift_y(phi, 1)
    m1y, m2y = shift_y(phi, -1), shift_y(phi, -2)
    neg_y = -2.0 * p2y + 10.0 * p1y - 9.0 * phi + 2.0 * m1y - 1.0 * m2y
    pos_y = 1.0 * p2y - 2.0 * p1y + 9.0 * phi - 10.0 * m1y + 2.0 * m2y
    b = torch.where(w < 0.0, neg_y, pos_y) / (6.0 * dx)

    return u * a + w * b
