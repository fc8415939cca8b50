"""Simulator façade and run loop (port of
``fluid2d_tpu/models/simulator.py``: ``make_step_fn``, ``make_run_fn``
and the ``FluidSimulator`` create / step / field_to_numpy / state surface).

PyTorch runs eagerly, so the run loop is a Python loop. It keeps the JAX
package's shape — a two-step body plus a one-step remainder — so that a
later graph-captured body drops in with the same buffer period.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fluid2d_tpu_torch.config import SimConfig
from fluid2d_tpu_torch.models.cip import cip_step
from fluid2d_tpu_torch.models.mac import mac_step
from fluid2d_tpu_torch.scenes.compile import Scene, get_scene
from fluid2d_tpu_torch.state import SimState, init_state

__all__ = ["FluidSimulator", "make_step_fn", "make_run_fn", "scene_for_dtype"]


def scene_for_dtype(scene: Scene, cfg: SimConfig) -> Scene:
    """The scene with its float planes (inflow velocity, dye colours) in the
    transport dtype, so that every kernel operand of a phase shares one
    storage dtype; the masks are unchanged. Identity for float32 (port of
    ``fluid2d_tpu/models/simulator.py:30-39``)."""
    dt = getattr(torch, cfg.dtype)
    if scene.bc_const.dtype == dt:
        return scene
    return scene._replace(bc_const=scene.bc_const.to(dt), bc_dye=scene.bc_dye.to(dt))


def make_step_fn(cfg: SimConfig):
    """The single step ``(state, scene) → state`` for `cfg`: the CIP step,
    or the MAC step for the upwind and KK schemes."""
    return functools.partial(cip_step if cfg.scheme == "cip" else mac_step, cfg=cfg)


def make_run_fn(cfg: SimConfig):
    """``(state, scene, n) → state`` running n steps: n // 2 iterations
    of a two-step body, then one step if n is odd."""
    step = make_step_fn(cfg)

    def run(state: SimState, scene: Scene, n: int) -> SimState:
        pairs, rem = divmod(n, 2)
        for _ in range(pairs):
            state = step(step(state, scene), scene)
        if rem:
            state = step(state, scene)
        return state

    return run


class FluidSimulator:
    """The reference façade's create / step / fields surface
    (``fs/fluid_simulator.py:60-108,128-176``), on tensors of one device."""

    def __init__(self, scene: Scene, cfg: SimConfig, device: torch.device | str):
        self.scene = scene_for_dtype(scene, cfg)
        self.cfg = cfg
        self.state = init_state(scene, cfg, device)
        self._run = make_run_fn(cfg)

    @classmethod
    def create(
        cls,
        bc_num: int,
        resolution: int,
        *,
        device: torch.device | str,
        dt: float | None = None,
        re: float = 1_000_000.0,
        vor_eps: float | None = 5.0,
        scheme: str = "cip",
        enable_dye: bool = True,
        mask_image: str | None = None,
        **config_overrides,
    ) -> "FluidSimulator":
        """Scene `bc_num` (or the `mask_image` silhouette scene) at
        `resolution`, its tensors and state on `device`."""
        cfg = SimConfig.create(
            resolution=resolution,
            dt=dt,
            re=re,
            scheme=scheme,
            vor_eps=vor_eps,
            enable_dye=enable_dye,
            **config_overrides,
        )
        scene = get_scene(bc_num, resolution, device, mask_image=mask_image)
        return cls(scene, cfg, device)

    def step(self, n: int = 1) -> None:
        """Advance n steps (kernel launches are queued; nothing waits on
        the device)."""
        self.state = self._run(self.state, self.scene, n)

    def field_to_numpy(self) -> dict[str, np.ndarray]:
        """Reference-layout field dump (``fs/fluid_simulator.py:34-36``):
        v → (X, Y, 2), p → (X, Y), dye → (X, Y, 3) when present; float32
        whatever the transport dtype (bf16 widens exactly)."""
        st = self.state
        out = {
            "v": np.moveaxis(st.v.float().cpu().numpy(), 0, -1),
            "p": st.p.float().cpu().numpy(),
        }
        if st.dye is not None:
            out["dye"] = np.moveaxis(st.dye.float().cpu().numpy(), 0, -1)
        return out
