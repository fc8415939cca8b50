"""Scene compilation: static boundary-condition analysis → tensor Scene
(port of ``fluid2d_tpu/scenes/compile.py``).

The NumPy analysis is the JAX package's, unchanged; only the last step
differs: the leaves become tensors on the device the caller names. The
eager ops read the bool masks and ``vbc_targets``; the CUDA kernels read
the int8 planes (``fluid8``, ``not_wall8``, ``inflow8``, ``vbc_code``,
``pbc_code``).

Velocity ghost patterns (trigger cell is an interior wall cell, elif
priority 1→4; the *target* receives the negated mirror of the fluid cell
two cells away):

  ==  trigger condition (at wall cell t-δ)                target t  source
  1   fluid at i-1, walls at j±1                          (i+1, j)  (i-1, j)
  2   fluid at i+1, walls at j±1                          (i-1, j)  (i+1, j)
  3   fluid at j-1, walls at i±1                          (i, j+1)  (i, j-1)
  4   fluid at j+1, walls at i±1                          (i, j-1)  (i, j+1)

Pressure pattern codes (elif priority; clamped mask reads at grid edges,
``docs/PARITY.md`` §edge-semantics):

  0 untouched   1..4 copy from (i∓1, j)/(i, j∓1)   5..8 corner averages
  9 inflow: copy from (i+1, j)                     10 outflow: 0
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Scene", "compile_scene", "get_scene", "scene_arrays"]


class Scene(NamedTuple):
    """Static scene tensors, every leaf shaped over the (X, Y) grid."""

    bc_const: torch.Tensor  # (2, X, Y) float32 imposed inflow velocity
    bc_dye: torch.Tensor  # (3, X, Y) float32 inflow dye color
    mask: torch.Tensor  # (X, Y) uint8: 0 fluid / 1 wall / 2 inflow / 3 outflow
    fluid: torch.Tensor  # (X, Y) bool
    wall: torch.Tensor
    not_wall: torch.Tensor
    inflow: torch.Tensor
    outflow: torch.Tensor
    odd_fluid: torch.Tensor  # fluid & (i+j) odd — red-black SOR colors
    even_fluid: torch.Tensor
    vbc_targets: torch.Tensor  # (4, X, Y) bool ghost-velocity target masks
    pbc_code: torch.Tensor  # (X, Y) int8 pressure pattern code 0..10
    fluid8: torch.Tensor  # (X, Y) int8 fluid mask (the kernels' layout)
    not_wall8: torch.Tensor  # (X, Y) int8 ¬wall mask
    inflow8: torch.Tensor  # (X, Y) int8 inflow mask
    vbc_code: torch.Tensor  # (X, Y) int8 velocity-BC action: 0 none,
    # 1..4 ghost pattern (priority 4>3>2>1 like the runtime where-chain),
    # 5 inflow, 6 outflow.

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.mask.shape)


def _shifted(m: np.ndarray, di: int, dj: int) -> np.ndarray:
    """m[clamp(i+di), clamp(j+dj)] with edge replication (NumPy, host)."""
    out = m
    if di:
        out = np.pad(out, ((max(-di, 0), max(di, 0)), (0, 0)), mode="edge")
        out = out[max(di, 0) : out.shape[0] - max(-di, 0), :]
    if dj:
        out = np.pad(out, ((0, 0), (max(-dj, 0), max(dj, 0))), mode="edge")
        out = out[:, max(dj, 0) : out.shape[1] - max(-dj, 0)]
    return out


def _velocity_ghost_targets(mask: np.ndarray) -> np.ndarray:
    """(4, X, Y) bool target masks for the ghost-velocity mirror writes."""
    x_res, y_res = mask.shape
    wall = mask == 1
    interior = np.zeros_like(wall)
    interior[1 : x_res - 1, 1 : y_res - 1] = True

    fl_xm = _shifted(mask, -1, 0) == 0  # fluid at (i-1, j)
    fl_xp = _shifted(mask, 1, 0) == 0
    fl_ym = _shifted(mask, 0, -1) == 0
    fl_yp = _shifted(mask, 0, 1) == 0
    wa_xm = _shifted(mask, -1, 0) == 1
    wa_xp = _shifted(mask, 1, 0) == 1
    wa_ym = _shifted(mask, 0, -1) == 1
    wa_yp = _shifted(mask, 0, 1) == 1

    base = wall & interior
    trig = np.zeros((4, x_res, y_res), dtype=bool)
    trig[0] = base & fl_xm & wa_ym & wa_yp
    trig[1] = base & ~trig[0] & fl_xp & wa_ym & wa_yp
    trig[2] = base & ~trig[0] & ~trig[1] & fl_ym & wa_xm & wa_xp
    trig[3] = base & ~trig[0] & ~trig[1] & ~trig[2] & fl_yp & wa_xm & wa_xp

    targets = np.zeros_like(trig)
    targets[0, 1:, :] = trig[0, :-1, :]  # trigger writes (i+1, j)
    targets[1, :-1, :] = trig[1, 1:, :]  # trigger writes (i-1, j)
    targets[2, :, 1:] = trig[2, :, :-1]  # trigger writes (i, j+1)
    targets[3, :, :-1] = trig[3, :, 1:]  # trigger writes (i, j-1)

    # Two triggers can target the same ghost cell; the runtime applies
    # patterns in order 1→4, so pattern 4 > 3 > 2 > 1 wins
    # (docs/PARITY.md §2).
    return targets


def _pressure_codes(mask: np.ndarray) -> np.ndarray:
    """(X, Y) int8 pattern code per cell, honoring the reference's elif
    priority (``fs/boundary_condition.py:45-65``)."""
    fl_xm = _shifted(mask, -1, 0) == 0
    fl_xp = _shifted(mask, 1, 0) == 0
    fl_ym = _shifted(mask, 0, -1) == 0
    fl_yp = _shifted(mask, 0, 1) == 0
    wa_xm = _shifted(mask, -1, 0) == 1
    wa_xp = _shifted(mask, 1, 0) == 1
    wa_ym = _shifted(mask, 0, -1) == 1
    wa_yp = _shifted(mask, 0, 1) == 1

    conds = [
        fl_xm & wa_ym & wa_yp,  # 1: copy p(i-1, j)
        fl_xp & wa_ym & wa_yp,  # 2: copy p(i+1, j)
        fl_ym & wa_xm & wa_xp,  # 3: copy p(i, j-1)
        fl_yp & wa_xm & wa_xp,  # 4: copy p(i, j+1)
        fl_xm & fl_yp,  # 5: avg p(i-1, j), p(i, j+1)
        fl_xp & fl_yp,  # 6
        fl_xm & fl_ym,  # 7
        fl_xp & fl_ym,  # 8
    ]
    code = np.zeros(mask.shape, dtype=np.int8)
    undecided = mask == 1
    for k, cond in enumerate(conds, start=1):
        hit = undecided & cond
        code[hit] = k
        undecided &= ~hit
    code[mask == 2] = 9
    code[mask == 3] = 10
    return code


def scene_arrays(bc: np.ndarray, bc_mask: np.ndarray, bc_dye: np.ndarray) -> dict[str, np.ndarray]:
    """The static BC analysis of raw scene arrays (reference layout
    (X, Y, C)): a dict of NumPy arrays keyed by the ``Scene`` field names,
    channel-leading."""
    mask = np.asarray(bc_mask, dtype=np.uint8)
    parity = (np.add.outer(np.arange(mask.shape[0]), np.arange(mask.shape[1])) % 2).astype(bool)
    fluid = mask == 0

    targets = _velocity_ghost_targets(mask)
    vbc_code = np.zeros(mask.shape, dtype=np.int8)
    for k in range(4):  # ascending: later patterns overwrite (4 > 3 > 2 > 1)
        vbc_code[targets[k]] = k + 1
    overlap = targets.any(axis=0) & (mask >= 2)
    if overlap.any():
        # The packed code stores one action per cell; inflow/outflow wins
        # here like the runtime where-chain — but the chain's outflow only
        # overrides the x-component, keeping a ghost-written y. No built-in
        # scene has such cells; warn for custom geometry (docs/PARITY.md §2).
        warnings.warn(
            f"{int(overlap.sum())} ghost-velocity targets coincide with "
            "inflow/outflow cells; the CUDA BC path keeps those cells' "
            "y-component un-ghosted (the eager path ghost-writes it first)",
            stacklevel=2,
        )
    vbc_code[mask == 2] = 5
    vbc_code[mask == 3] = 6

    return {
        "bc_const": np.moveaxis(bc.astype(np.float32), -1, 0),
        "bc_dye": np.moveaxis(bc_dye.astype(np.float32), -1, 0),
        "mask": mask,
        "fluid": fluid,
        "wall": mask == 1,
        "not_wall": mask != 1,
        "inflow": mask == 2,
        "outflow": mask == 3,
        "odd_fluid": fluid & parity,
        "even_fluid": fluid & ~parity,
        "vbc_targets": targets,
        "pbc_code": _pressure_codes(mask),
        "fluid8": fluid.astype(np.int8),
        "not_wall8": (mask != 1).astype(np.int8),
        "inflow8": (mask == 2).astype(np.int8),
        "vbc_code": vbc_code,
    }


def compile_scene(bc: np.ndarray, bc_mask: np.ndarray, bc_dye: np.ndarray,
                  device: torch.device | str) -> Scene:
    """Turn raw scene arrays into a ``Scene`` of contiguous tensors on
    `device`."""
    from fluid2d_tpu_torch.convert import scene_from_numpy  # convert imports this module

    return scene_from_numpy(scene_arrays(bc, bc_mask, bc_dye), device)


def get_scene(num: int, resolution: int, device: torch.device | str, mask_image=None) -> Scene:
    """Build and compile built-in scene `num` (1..6) at y-resolution
    `resolution` onto `device` (parity surface: ``get_boundary_condition``,
    ``fs/boundary_condition.py:201-219``). `mask_image` (path or bundled
    asset name "dragon"/"rabbit"/"aircraft") swaps in a custom obstacle
    silhouette scene."""
    from fluid2d_tpu_torch.scenes.scenes import build_scene_arrays

    return compile_scene(*build_scene_arrays(num, resolution, mask_image=mask_image), device)
