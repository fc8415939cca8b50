"""Simulator façade and run loop (port of
``fluid2d_tpu/models/simulator.py``: ``make_step_fn``, ``make_run_fn``
and the whole ``FluidSimulator``: create, step, reset, the four views,
screenshot, field dump, and ``.npz`` checkpoint save / load).

PyTorch runs eagerly, so ``make_run_fn`` is a Python loop; it keeps the
JAX package's shape, a two-step body plus a one-step remainder. On a CUDA
state on the kernel path ``FluidSimulator.step`` replays CUDA graphs of
the step instead (``models/replay.py``), over a fixed cycle of buffers of
period two.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from fluid2d_tpu_torch.config import SimConfig, resolve_device
from fluid2d_tpu_torch.models.cip import cip_step
from fluid2d_tpu_torch.models.mac import mac_step
from fluid2d_tpu_torch.models.replay import StepGraphs, engages, graph_key
from fluid2d_tpu_torch.scenes.compile import Scene, get_scene
from fluid2d_tpu_torch.state import SimState, init_state
from fluid2d_tpu_torch.utils import io as fio
from fluid2d_tpu_torch.utils import trace
from fluid2d_tpu_torch.utils.trace import to_host
from fluid2d_tpu_torch.utils.viz import render_rgb, to_image

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
    """The reference façade (``fs/fluid_simulator.py:13-176``) on tensors
    of one device: ``create`` mirrors its scene wiring and defaults, the
    ``get_*_field`` methods its render kernels; ``enable_dye`` replaces
    the separate ``DyeFluidSimulator``. The device is `device`, or the
    scene's when None; a given `state` (resume, dtype override) is re-cast
    to the config's transport dtype, exactly for values that started as
    bf16 stores."""

    def __init__(self, scene: Scene, cfg: SimConfig, state: SimState | None = None,
                 scene_meta: dict | None = None, device: torch.device | str | None = None):
        self.device = scene.mask.device if device is None else resolve_device(device)
        scene = Scene(*(t.to(self.device) for t in scene))
        self.scene = scene_for_dtype(scene, cfg)
        self.cfg = cfg
        self.scene_meta = scene_meta or {}
        if state is None:
            self.state = init_state(scene, cfg, self.device)
        else:
            self.state = fio._cast_state(SimState(*(
                None if leaf is None else leaf.to(self.device) for leaf in state)), cfg)
        self._run = make_run_fn(cfg)
        self._graphs: StepGraphs | None = None

    # -- construction ------------------------------------------------------
    @classmethod
    def create(
        cls,
        bc_num: int,
        resolution: int,
        dt: float | None = None,
        re: float = 1_000_000.0,
        vor_eps: float | None = 5.0,
        scheme: str = "cip",
        enable_dye: bool = True,
        mask_image: str | None = None,
        *,
        device: torch.device | str = "cuda",
        **config_overrides,
    ) -> "FluidSimulator":
        """Scene `bc_num` (or the `mask_image` silhouette scene: an image
        path or a bundled asset name, dragon, rabbit, aircraft) at
        `resolution`, its tensors and state on `device` (the card unless
        the caller names the CPU; raises without a card)."""
        cfg = SimConfig.create(
            resolution=resolution,
            dt=dt,
            re=re,
            scheme=scheme,
            vor_eps=vor_eps,
            enable_dye=enable_dye,
            **config_overrides,
        )
        scene = get_scene(bc_num, resolution, resolve_device(device), mask_image=mask_image)
        return cls(scene, cfg, scene_meta={"bc_num": bc_num, "mask_image": mask_image})

    # -- stepping ----------------------------------------------------------
    def step(self, n: int = 1) -> None:
        """Advance n steps (the work is queued; nothing waits on the device).

        On a CUDA state with the kernels (not ``kernels="eager"``) and a
        pressure solve (``n_pressure_iter`` > 0), the steps are replays of
        CUDA graphs of the step (``models/replay.py``), bit-identical to the
        eager loop; otherwise the eager loop (``make_run_fn``) runs. The
        graph path donates the state, as the JAX package's run does: its
        leaves are the graphs' buffers and are written in place, so a state
        or leaf held from before a call holds another step's values after
        it. Copy what must be kept (``clone()``, or to the host)."""
        if engages(self.cfg, self.state.v.device):
            if self._graphs is None or self._graphs.key != graph_key(self.cfg, self.scene):
                self._graphs = StepGraphs(self.state, self.scene, self.cfg)
            self.state = self._graphs.run(self.state, n)
            return
        if self.state.v.device.type == "cuda":
            trace.eager_cuda_steps += max(n, 0)
        self.state = self._run(self.state, self.scene, n)

    def reset(self) -> None:
        """Zero all fields (the reference's unused ``DoubleBuffer.reset``
        capability, ``fs/double_buffer.py:16``)."""
        self.state = init_state(self.scene, self.cfg, self.device)

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    # -- rendering (parity with fs/fluid_simulator.py:22-32,113-115) --------
    def render(self, vis: int | str = 0) -> torch.Tensor:
        """View `vis` of the current state as an (X, Y, 3) float32 tensor
        on the state's device."""
        return render_rgb(self.state, self.scene, self.cfg, vis)

    def _render(self, state: SimState, scene: Scene, vis: int | str) -> torch.Tensor:
        """`render` of a given state and scene (the JAX façade's name)."""
        return render_rgb(state, scene, self.cfg, vis)

    def get_norm_field(self) -> np.ndarray:
        return to_host(self.render(0)).numpy()

    def get_pressure_field(self) -> np.ndarray:
        return to_host(self.render(1)).numpy()

    def get_vorticity_field(self) -> np.ndarray:
        return to_host(self.render(2)).numpy()

    def get_dye_field(self) -> np.ndarray:
        return to_host(self.render(3)).numpy()

    def screenshot(self, path: str | Path, vis: int = 0) -> None:
        """Render and write a PNG (the reference's ``s`` key,
        ``main.py:124-128``)."""
        fio.write_png(path, to_image(self.render(vis)))

    # -- IO ------------------------------------------------------------------
    def field_to_numpy(self) -> dict[str, np.ndarray]:
        """Reference-layout field dump (``fs/fluid_simulator.py:34-36``):
        v → (X, Y, 2), p → (X, Y), dye → (X, Y, 3) when present; float32
        whatever the transport dtype (bf16 widens exactly)."""
        return fio.fields_to_numpy(self.state)

    def save(self, path: str | Path) -> None:
        """Full-state ``.npz`` checkpoint, loadable by either package."""
        fio.save_checkpoint(path, self.state, self.cfg, scene_meta=self.scene_meta)

    @classmethod
    def load(cls, path: str | Path, bc_num: int | None = None,
             mask_image: str | None = None,
             device: torch.device | str = "cuda") -> "FluidSimulator":
        """Exact resume from a full-state checkpoint of either package, onto
        `device`. The scene identity is stored in the checkpoint;
        `bc_num` / `mask_image` are explicit overrides."""
        dev = resolve_device(device)
        state, cfg, meta = fio.load_checkpoint(path, dev)
        bc = bc_num if bc_num is not None else meta.get("bc_num", 1)
        if bc_num is not None and mask_image is None:
            # An explicit bc override replaces the scene identity: do NOT
            # inherit a stored mask image (get_scene short-circuits on
            # mask_image before reading bc_num, so inheriting it would
            # silently keep the old obstacle layout).
            if meta.get("mask_image"):
                print(f"note: -bc {bc_num} overrides the checkpoint's scene; "
                      f"the stored mask image ({meta['mask_image']}) is "
                      f"discarded (pass --mask-image to keep it)")
            mask = None
        else:
            mask = mask_image if mask_image is not None else meta.get("mask_image")
        scene = get_scene(bc, cfg.resolution, dev, mask_image=mask)
        return cls(scene, cfg, state=state, scene_meta={"bc_num": bc, "mask_image": mask})
