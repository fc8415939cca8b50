"""fluid2d_tpu_torch — the PyTorch and CUDA port of fluid2d_tpu.

Scene builders, eager ops, the CIP and MAC (upwind, Kawamura-Kuwahara)
steps with the SOR or Jacobi pressure solver, float32 or bf16 transport,
and the run loop in PyTorch,
with every phase kernel hand-written in CUDA C++ for Hopper (``csrc/``). The JAX package ``fluid2d_tpu`` is the reference the
port is held against; this package never imports JAX.
"""

from fluid2d_tpu_torch.config import SimConfig, default_dt
from fluid2d_tpu_torch.models.simulator import (
    FluidSimulator,
    make_run_fn,
    make_step_fn,
    scene_for_dtype,
)
from fluid2d_tpu_torch.scenes.compile import Scene, compile_scene, get_scene
from fluid2d_tpu_torch.state import SimState, init_state

__version__ = "0.1.0"

__all__ = [
    "FluidSimulator",
    "Scene",
    "SimConfig",
    "SimState",
    "compile_scene",
    "default_dt",
    "get_scene",
    "init_state",
    "make_run_fn",
    "make_step_fn",
    "scene_for_dtype",
]
