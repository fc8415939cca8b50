"""Clamp-to-edge stencil primitives on whole tensors (port of
``fluid2d_tpu/ops/stencil.py``).

* Out-of-range reads clamp to the edge (replicate padding), like the
  reference's ``sample`` (``fs/differentiation.py:6-7``); ``torch.roll``
  (wrap) would be wrong at borders.
* Grids are tensors of shape ``(..., X, Y)``; dim -2 is x, dim -1 is y
  (contiguous). Leading dims (velocity/dye channels) broadcast through.
* float32 arithmetic in the same association order as the reference.
"""

from __future__ import annotations

import torch

__all__ = [
    "shift_x",
    "shift_y",
    "shift2",
    "sign",
    "tmin",
    "tmax",
    "fdiff_x",
    "fdiff_y",
    "bdiff_x",
    "bdiff_y",
    "diff_x",
    "diff_y",
    "diff2_x",
    "diff2_y",
]


def _shift(f: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """out[..., k, ...] = f[..., clamp(k + d), ...] along `dim`."""
    if d == 0:
        return f
    n = f.shape[dim]
    if d > 0:
        body = f.narrow(dim, d, n - d)
        edge = f.narrow(dim, n - 1, 1)
        return torch.cat([body, *([edge] * d)], dim=dim)
    body = f.narrow(dim, 0, n + d)
    edge = f.narrow(dim, 0, 1)
    return torch.cat([*([edge] * -d), body], dim=dim)


def shift_x(f: torch.Tensor, d: int) -> torch.Tensor:
    """out[..., i, j] = f[..., clamp(i + d), j] (clamp-to-edge)."""
    return _shift(f, d, f.dim() - 2)


def shift_y(f: torch.Tensor, d: int) -> torch.Tensor:
    """out[..., i, j] = f[..., i, clamp(j + d)] (clamp-to-edge)."""
    return _shift(f, d, f.dim() - 1)


def shift2(f: torch.Tensor, dx_: int, dy_: int) -> torch.Tensor:
    """out[..., i, j] = f[..., clamp(i + dx_), clamp(j + dy_)]."""
    return shift_y(shift_x(f, dx_), dy_)


def sign(x: torch.Tensor) -> torch.Tensor:
    """-1.0 where x < 0 else +1.0 (sign(0) == sign(nan) == +1).

    Mirrors ``fs/differentiation.py:13-14``; NaN compares false so maps to +1.
    """
    return 1.0 - 2.0 * (x < 0.0).to(x.dtype)


def tmin(x: torch.Tensor, c: float) -> torch.Tensor:
    """min with fmin NaN semantics: NaN in `x` yields `c`.

    The reference's ``ti.min`` lowers to fmin, which returns the non-NaN
    operand; ``torch.minimum`` propagates NaN instead. The distinction is
    load-bearing in vorticity confinement, where an unguarded 0/0 yields
    NaN that the reference then clamps to the limit
    (``fs/vorticity_confinement.py:49,55``). `c` is a NaN-free constant.
    """
    return torch.fmin(x, x.new_full((), c))


def tmax(x: torch.Tensor, c: float) -> torch.Tensor:
    """max with fmax NaN semantics: NaN in `x` yields `c`. See `tmin`."""
    return torch.fmax(x, x.new_full((), c))


def fdiff_x(f: torch.Tensor, dx: float) -> torch.Tensor:
    """Forward difference in x (``fs/differentiation.py:18-20``)."""
    return (shift_x(f, 1) - f) / dx


def fdiff_y(f: torch.Tensor, dx: float) -> torch.Tensor:
    """Forward difference in y (``fs/differentiation.py:24-26``)."""
    return (shift_y(f, 1) - f) / dx


def bdiff_x(f: torch.Tensor, dx: float) -> torch.Tensor:
    """Backward difference in x (``fs/differentiation.py:30-32``)."""
    return (f - shift_x(f, -1)) / dx


def bdiff_y(f: torch.Tensor, dx: float) -> torch.Tensor:
    """Backward difference in y (``fs/differentiation.py:36-38``)."""
    return (f - shift_y(f, -1)) / dx


def diff_x(f: torch.Tensor, dx: float) -> torch.Tensor:
    """Central difference in x (``fs/differentiation.py:42-44``)."""
    return 0.5 * (shift_x(f, 1) - shift_x(f, -1)) / dx


def diff_y(f: torch.Tensor, dx: float) -> torch.Tensor:
    """Central difference in y (``fs/differentiation.py:48-50``)."""
    return 0.5 * (shift_y(f, 1) - shift_y(f, -1)) / dx


def diff2_x(f: torch.Tensor, dx: float) -> torch.Tensor:
    """Second derivative in x (``fs/differentiation.py:54-55``)."""
    return (shift_x(f, 1) - 2.0 * f + shift_x(f, -1)) / dx**2


def diff2_y(f: torch.Tensor, dx: float) -> torch.Tensor:
    """Second derivative in y (``fs/differentiation.py:59-60``)."""
    return (shift_y(f, 1) - 2.0 * f + shift_y(f, -1)) / dx**2
