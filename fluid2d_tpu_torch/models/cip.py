"""CIP MAC solver step (port of ``fluid2d_tpu/models/cip.py``; reference
``CipMacSolver`` / ``DyeCipMacSolver``, ``fs/solver.py:165-401``).

Phase order per step, with the same (cur, alt) assignments as the JAX
package:

1. velocity phase: BC, non-advection (pressure + diffusion) at not-wall
   cells, gradient update from the change, CIP advection at fluid cells;
2. vorticity confinement (optional);
3. SOR pressure iterations, the velocity limiter folded into the last;
4. dye phase (optional): the same structure on the 3-channel dye with
   diffusion only, advected by the *limited* velocity, clamped to [0, 1].
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.config import SimConfig
from fluid2d_tpu_torch.models.common import (
    confinement,
    out_kw,
    update_pressure_and_limit,
    use_kernels,
)
from fluid2d_tpu_torch.ops.cuda_phases import (
    cip_dye_phase_cuda,
    cip_dye_phase_plain,
    cip_velocity_phase_cuda,
    cip_velocity_phase_plain,
)
from fluid2d_tpu_torch.scenes.compile import Scene
from fluid2d_tpu_torch.state import SimState
from fluid2d_tpu_torch.utils.trace import span

__all__ = ["cip_step"]


def cip_step(state: SimState, scene: Scene, cfg: SimConfig, out=None) -> SimState:
    """One CIP time step (``CipMacSolver.update``, ``fs/solver.py:192-202``;
    dye tail: ``DyeCipMacSolver.update``, ``:353-373``). With `out` (the
    phases' planned outputs, ``models/common.py``) every output, the step
    counter's included, lands in the tensors it names."""
    with span("f2d.step"):
        kernels = use_kernels(cfg, state.v)
        velocity_phase = cip_velocity_phase_cuda if kernels else cip_velocity_phase_plain
        v_cur, vx_cur, vy_cur, v_alt, vx_alt, vy_alt = velocity_phase(
            state.v, state.p, state.v_alt, state.vx, state.vx_alt, state.vy, state.vy_alt,
            scene, cfg.re, cfg.dt, cfg.dx, **out_kw(out, "velocity"),
        )

        if cfg.vor_eps is not None:
            v_cur, v_alt = confinement(v_cur, v_alt, scene, cfg, out)

        p_cur, p_alt, v_cur = update_pressure_and_limit(state.p, state.p_alt, v_cur, scene, cfg,
                                                        out)

        kw = dict(
            step=state.step + 1 if out is None else torch.add(state.step, 1, out=out["step"][0]),
            v=v_cur,
            v_alt=v_alt,
            vx=vx_cur,
            vx_alt=vx_alt,
            vy=vy_cur,
            vy_alt=vy_alt,
            p=p_cur,
            p_alt=p_alt,
        )

        if cfg.enable_dye:
            dye_phase = cip_dye_phase_cuda if kernels else cip_dye_phase_plain
            dye_cur, dyex_cur, dyey_cur, d_na, dx_na, dy_na = dye_phase(
                state.dye, state.dye_alt, state.dyex, state.dyex_alt, state.dyey, state.dyey_alt,
                v_cur, scene, cfg.re, cfg.dt, cfg.dx, **out_kw(out, "dye"),
            )
            kw.update(
                dye=dye_cur,
                dye_alt=d_na,
                dyex=dyex_cur,
                dyex_alt=dx_na,
                dyey=dyey_cur,
                dyey_alt=dy_na,
            )

        return state._replace(**kw)
