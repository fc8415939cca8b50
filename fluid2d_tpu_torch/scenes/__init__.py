"""Boundary-condition scenes: host-side geometry builders, the six
built-in scenes, static BC compilation, and runtime BC application."""

from fluid2d_tpu_torch.scenes.compile import Scene, compile_scene, get_scene

__all__ = ["Scene", "compile_scene", "get_scene"]
