"""Simulation state (port of ``fluid2d_tpu/state.py``).

The reference's mutable ``DoubleBuffer`` pairs become explicit
``(cur, alt)`` tensor pairs. The alternate buffers are part of the
observable behavior: non-fluid cells skipped by masked updates keep data
from one or two steps earlier, and the SOR even sweep reads them
(``docs/PARITY.md`` §1). Fields are channel-leading ``(C, X, Y)`` with Y
contiguous, the JAX package's layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fluid2d_tpu_torch.config import SimConfig
from fluid2d_tpu_torch.ops.cip import grad_of
from fluid2d_tpu_torch.scenes.compile import Scene

__all__ = ["SimState", "init_state"]


class SimState(NamedTuple):
    """Optional leaves are ``None`` when the config disables the
    corresponding feature (CIP gradients, dye)."""

    step: torch.Tensor  # () int32 step counter
    v: torch.Tensor  # (2, X, Y) velocity, current
    v_alt: torch.Tensor
    p: torch.Tensor  # (X, Y) pressure, current
    p_alt: torch.Tensor
    vx: Optional[torch.Tensor] = None  # (2, X, Y) CIP ∂v/∂x
    vx_alt: Optional[torch.Tensor] = None
    vy: Optional[torch.Tensor] = None  # (2, X, Y) CIP ∂v/∂y
    vy_alt: Optional[torch.Tensor] = None
    dye: Optional[torch.Tensor] = None  # (3, X, Y)
    dye_alt: Optional[torch.Tensor] = None
    dyex: Optional[torch.Tensor] = None  # (3, X, Y) CIP dye gradients
    dyex_alt: Optional[torch.Tensor] = None
    dyey: Optional[torch.Tensor] = None
    dyey_alt: Optional[torch.Tensor] = None


def init_state(scene: Scene, cfg: SimConfig, device: torch.device | str) -> SimState:
    """All-zero initial fields on `device`, with CIP gradients initialized
    from the (zero) fields like the reference's ``_set_grad``
    (``fs/solver.py:190,351``)."""
    x_res, y_res = scene.shape
    dt = getattr(torch, cfg.dtype)

    def zf(c=None):
        shape = (x_res, y_res) if c is None else (c, x_res, y_res)
        return torch.zeros(shape, dtype=dt, device=device)

    kw = dict(
        step=torch.zeros((), dtype=torch.int32, device=device),
        v=zf(2),
        v_alt=zf(2),
        p=zf(),
        p_alt=zf(),
    )
    if cfg.scheme == "cip":
        gx, gy = grad_of(kw["v"], cfg.dx)
        kw.update(vx=gx.to(dt), vx_alt=zf(2), vy=gy.to(dt), vy_alt=zf(2))
    if cfg.enable_dye:
        kw.update(dye=zf(3), dye_alt=zf(3))
        if cfg.scheme == "cip":
            dgx, dgy = grad_of(kw["dye"], cfg.dx)
            kw.update(dyex=dgx.to(dt), dyex_alt=zf(3), dyey=dgy.to(dt), dyey_alt=zf(3))
    return SimState(**kw)
