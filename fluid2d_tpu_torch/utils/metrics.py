"""Run-time diagnostics (port of ``fluid2d_tpu/utils/metrics.py``):
velocity divergence (what the pressure solve drives down), max speed (the
limiter's input), pressure scale, and NaN detection, computed on the
state's device in float32 whatever the transport dtype.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.stencil import diff_x, diff_y

__all__ = ["divergence", "diagnostics", "has_nan"]


def divergence(v, dx: float):
    """∇·v on the collocated grid (central differences)."""
    return diff_x(v[0], dx) + diff_y(v[1], dx)


def _diag_arrays(v, p, fluid, dx):
    """(RMS divergence over fluid cells, max speed, max |p|, any NaN in v
    or p) as 0-d tensors on the state's device."""
    v = v.float()  # diagnostics in f32 whatever the transport dtype
    p = p.float()
    div = torch.where(fluid, divergence(v, dx), torch.zeros((), dtype=v.dtype, device=v.device))
    speed = torch.sqrt(v[0] ** 2 + v[1] ** 2)
    n_fluid = torch.clamp_min(fluid.sum(), 1)
    return (
        torch.sqrt((div**2).sum() / n_fluid),
        speed.max(),
        p.abs().max(),
        torch.isnan(v).any() | torch.isnan(p).any(),
    )


def diagnostics(state, scene, cfg) -> str:
    """One log fragment, ``div_rms=… max|v|=… max|p|=…``, with
    ``** NaN DETECTED **`` appended when v or p holds a NaN; one
    device→host read."""
    div_rms, vmax, pmax, nan = _diag_arrays(state.v, state.p, scene.fluid, cfg.dx)
    div_rms, vmax, pmax, nan = torch.stack([div_rms, vmax, pmax, nan.float()]).tolist()
    s = f"div_rms={div_rms:.3e} max|v|={vmax:.3f} max|p|={pmax:.3e}"
    if nan:
        s += "  ** NaN DETECTED **"
    return s


def has_nan(state) -> bool:
    """NaN guard over the primary fields (a reduction on the device, one
    read)."""
    leaves = [state.v, state.p] + ([state.dye] if state.dye is not None else [])
    return bool(torch.stack([torch.isnan(x).any() for x in leaves]).any())
