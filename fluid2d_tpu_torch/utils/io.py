"""Checkpoints, field dumps and image output (port of the ``.npz`` half
of ``fluid2d_tpu/utils/io.py``).

A checkpoint holds every state leaf (each buffer pair, the CIP gradient
planes, the int32 step counter) and the config and scene identity, so a
run resumes exactly. The file is the JAX package's, byte for byte: the
same leaf names, bf16 leaves widened to float32 (exact), and a
``__config__`` uint8 JSON blob whose ``config`` carries the JAX package's
``SimConfig`` fields and ``kernels`` names, so either package loads what
the other wrote (:func:`config_to_jax`, :func:`config_from_jax`). The
orbax directory format is the JAX package's alone: a suffix-less path is
refused here.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from fluid2d_tpu_torch.config import SimConfig, resolve_device
from fluid2d_tpu_torch.convert import state_from_numpy, state_to_numpy
from fluid2d_tpu_torch.state import SimState
from fluid2d_tpu_torch.utils.trace import to_host

__all__ = [
    "fields_to_numpy",
    "save_checkpoint",
    "load_checkpoint",
    "config_to_jax",
    "config_from_jax",
    "write_png",
    "write_gif",
]

# The JAX package's SimConfig fields in its order (fluid2d_tpu/config.py):
# the port's fields plus sor_fuse, which the port's SOR has no choice of.
_JAX_CONFIG_FIELDS = ("resolution", "dt", "dx", "re", "scheme", "vor_eps", "enable_dye",
                      "pressure_solver", "sor_omega", "n_pressure_iter", "velocity_limit",
                      "kernels", "sor_fuse", "dtype")
_KERNELS_TO_JAX = {"auto": "auto", "cuda": "auto", "eager": "xla"}
_KERNELS_FROM_JAX = {"auto": "auto", "pallas": "auto", "pallas_interpret": "auto",
                     "xla": "eager"}


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as a host array; bf16 widened to float32 (exact: npz has no
    bfloat16)."""
    return to_host(leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()


def fields_to_numpy(state: SimState) -> dict[str, np.ndarray]:
    """Reference-layout field dump (``fs/fluid_simulator.py:34-36,117-119``):
    v → (X, Y, 2), p → (X, Y), dye → (X, Y, 3) when present."""
    out = {"v": np.moveaxis(_host(state.v), 0, -1), "p": _host(state.p)}
    if state.dye is not None:
        out["dye"] = np.moveaxis(_host(state.dye), 0, -1)
    return out


def _cast_state(state: SimState, cfg: SimConfig) -> SimState:
    """Re-narrow (or widen) float leaves to the config's transport dtype
    (identity when they already match; the int32 step untouched)."""
    dt = getattr(torch, cfg.dtype)
    return SimState(*(
        leaf.to(dt) if leaf is not None and leaf.is_floating_point() and leaf.dtype != dt
        else leaf
        for leaf in state
    ))


def config_to_jax(cfg: SimConfig) -> dict:
    """`cfg` as the JAX package's ``SimConfig`` fields: ``sor_fuse`` 1,
    ``kernels`` eager → xla and auto/cuda → auto."""
    fields = dataclasses.asdict(cfg) | {"kernels": _KERNELS_TO_JAX[cfg.kernels], "sor_fuse": 1}
    return {name: fields[name] for name in _JAX_CONFIG_FIELDS}


def config_from_jax(fields: dict) -> SimConfig:
    """A checkpoint's config as the port's ``SimConfig``: ``sor_fuse``
    dropped, ``kernels`` xla → eager and pallas/pallas_interpret/auto →
    auto."""
    fields = {k: v for k, v in fields.items() if k != "sor_fuse"}
    kernels = fields.get("kernels", "auto")
    if kernels not in _KERNELS_FROM_JAX:
        msg = f"checkpoint kernels mode {kernels!r} is not one the JAX package writes " \
              f"({', '.join(_KERNELS_FROM_JAX)})"
        raise ValueError(msg)
    return SimConfig(**{**fields, "kernels": _KERNELS_FROM_JAX[kernels]})


def _check_npz_path(path: Path) -> None:
    """Route by suffix as the JAX package does: ``.npz`` (any case) → one
    file; a suffix-less path (or a directory) names an orbax checkpoint,
    which only the JAX package reads and writes; any other suffix is
    refused rather than becoming a directory."""
    suffix = path.suffix.lower()
    if suffix == ".npz":
        return
    if suffix and not path.is_dir():
        msg = (f"unrecognized checkpoint suffix {path.suffix!r} (use '.npz' for a single file; "
               f"orbax directory checkpoints are JAX-only)")
        raise ValueError(msg)
    msg = (f"{path}: a suffix-less checkpoint path is an orbax directory, which is JAX-only "
           f"(fluid2d_tpu); use a '.npz' path")
    raise ValueError(msg)


def save_checkpoint(path: str | Path, state: SimState, cfg: SimConfig,
                    scene_meta: dict | None = None) -> None:
    """Full-state ``.npz`` checkpoint: every state leaf + the config (in the
    JAX package's fields) and scene identity as JSON."""
    path = Path(path)
    _check_npz_path(path)  # validate the path before any work
    meta = {"config": config_to_jax(cfg), "scene": scene_meta or {}}
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = state_to_numpy(state)
    arrays["__config__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint(path: str | Path, device: torch.device | str = "cuda"
                    ) -> tuple[SimState, SimConfig, dict]:
    """Restore (state, config, scene_meta) written by :func:`save_checkpoint`
    or by the JAX package's ``.npz`` writer; the state on `device` in the
    config's transport dtype."""
    path = Path(path)
    _check_npz_path(path)
    dev = resolve_device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__config__"].tobytes()).decode())
        cfg = config_from_jax(meta["config"])
        arrays = {name: data[name] for name in SimState._fields if name in data.files}
    return state_from_numpy(arrays, dev, cfg.dtype), cfg, meta.get("scene", {})


def write_png(path: str | Path, image: np.ndarray) -> None:
    """Write a uint8 H×W×3 image (see :func:`fluid2d_tpu_torch.utils.viz.to_image`)."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(image).save(path)


def write_gif(path: str | Path, frames, fps: int = 30) -> None:
    """Animate frames into a GIF (the reference's disabled VideoManager
    capability, ``main.py:86,109``).

    ``frames`` is an iterable of uint8 H×W×3 arrays **or image file
    paths**. Paths are opened one at a time through a generator, so a long
    animation streams from the already-written PNG frames at constant
    memory."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def to_img(f):
        return Image.open(f) if isinstance(f, (str, Path)) else Image.fromarray(f)

    it = iter(frames)
    first = to_img(next(it))
    first.save(
        path,
        save_all=True,
        append_images=(to_img(f) for f in it),
        duration=max(1, round(1000 / fps)),
        loop=0,
    )
