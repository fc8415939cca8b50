"""Field limiting / clamping safeguards (port of
``fluid2d_tpu/ops/limiters.py``), with the reference's NaN handling
(``fs/solver.py:38-49``): fmin/fmax return the non-NaN operand, so a NaN
field value clamps instead of propagating."""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.stencil import tmax, tmin

__all__ = ["limit_vector_norm", "clamp_field"]


def limit_vector_norm(v: torch.Tensor, limit: float) -> torch.Tensor:
    """Rescale vectors whose norm exceeds `limit` (``fs/solver.py:38-43``).

    `v` has shape (2, X, Y). Cells with norm ≤ limit (or NaN norm, which
    compares false, matching the reference's ``if norm > limit``) are
    unchanged.
    """
    norm = torch.sqrt(v[0] * v[0] + v[1] * v[1])
    scaled = limit * (v / norm)
    return torch.where(norm > limit, scaled, v)


def clamp_field(f: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Elementwise clamp via min(max(f, low), high) with fmin/fmax NaN
    semantics (``fs/solver.py:46-49``): NaN → low."""
    return tmin(tmax(f, low), high)
