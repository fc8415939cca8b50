"""MAC fractional-step solver with upwind or Kawamura-Kuwahara advection
(port of ``fluid2d_tpu/models/mac.py``; reference ``MacSolver`` /
``DyeMacSolver``, ``fs/solver.py:53-162``).

Phase order per step, with the same (cur, alt) assignments as the JAX
package:

1. velocity phase: BC on the current buffer, then
   ``v + dt·(−(v·∇)v − ∇p + ∇²v/Re)`` at fluid cells (the alternate
   elsewhere); the BC'd input becomes the alternate;
2. vorticity confinement (optional);
3. pressure iterations (SOR or Jacobi), the velocity limiter folded into
   the last call;
4. dye phase (optional): inflow BC, advection by the *limited* velocity at
   fluid cells, then a [0, 1] clamp of the current buffer only; the
   unclamped BC'd dye becomes the alternate.
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
    mac_dye_phase_cuda,
    mac_dye_phase_plain,
    mac_velocity_phase_cuda,
    mac_velocity_phase_plain,
)
from fluid2d_tpu_torch.scenes.compile import Scene
from fluid2d_tpu_torch.state import SimState
from fluid2d_tpu_torch.utils.trace import span

__all__ = ["mac_step"]


def mac_step(state: SimState, scene: Scene, cfg: SimConfig, out=None) -> SimState:
    """One MAC time step (``MacSolver.update``, ``fs/solver.py:79-89``;
    dye tail: ``DyeMacSolver.update``, ``:136-152``). With `out` (the
    phases' planned outputs, ``models/common.py``) every output, the step
    counter's included, lands in the tensors it names."""
    with span("f2d.step"):
        kernels = use_kernels(cfg, state.v)
        velocity_phase = mac_velocity_phase_cuda if kernels else mac_velocity_phase_plain
        v_cur, v_alt = velocity_phase(state.v, state.p, state.v_alt, scene, cfg.scheme, cfg.re,
                                      cfg.dt, cfg.dx, **out_kw(out, "velocity"))

        if cfg.vor_eps is not None:
            v_cur, v_alt = confinement(v_cur, v_alt, scene, cfg, out)

        p_cur, p_alt, v_cur = update_pressure_and_limit(state.p, state.p_alt, v_cur, scene, cfg,
                                                        out)

        step = state.step + 1 if out is None else torch.add(state.step, 1, out=out["step"][0])
        kw = dict(step=step, v=v_cur, v_alt=v_alt, p=p_cur, p_alt=p_alt)

        if cfg.enable_dye:
            dye_phase = mac_dye_phase_cuda if kernels else mac_dye_phase_plain
            dye_cur, dc = dye_phase(state.dye, state.dye_alt, v_cur, scene, cfg.scheme, cfg.dt,
                                    cfg.dx, **out_kw(out, "dye"))
            kw.update(dye=dye_cur, dye_alt=dc)

        return state._replace(**kw)
