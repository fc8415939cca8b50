"""The six built-in boundary-condition scenes (NumPy; port of
``fluid2d_tpu/scenes/scenes.py``, line for line).

Each function returns raw NumPy arrays ``(bc, bc_mask, bc_dye)`` of shape
(2·res, res, ·) with mask codes 0=fluid, 1=wall, 2=inflow, 3=outflow.
:func:`fluid2d_tpu_torch.scenes.compile.compile_scene` turns them into the
tensor ``Scene``.

Scene summary (reference ``fs/boundary_condition.py`` lines):
  1 channel flow past a cylinder            (:222-265)
  2 slalom walls with narrow outflow        (:268-319)
  3 100 random cylinders, seed 123          (:322-369)
  4 closed box, two inflows, center outflow (:372-418)
  5 multi-obstacle array with split inflow  (:421-479)
  6 image-mask obstacle (dragon silhouette) (:482-524)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fluid2d_tpu_torch.scenes.builder import (
    ASSET_DIR,
    color_ramp,
    new_scene_arrays,
    paint_box,
    paint_circle,
    paint_mask_image,
)

__all__ = ["build_scene_arrays", "SCENE_BUILDERS"]

# Inflow dye ramp control colors shared by scenes 1, 3, 4, 6.
_YELLOW = np.array([1.1, 1.1, 0.2])
_BLUE = np.array([0.2, 0.2, 1.1])
_RED = np.array([1.1, 0.2, 0.2])
_CYAN = np.array([0.2, 1.1, 1.1])


def _scene1(x_res: int, y_res: int):
    bc, mask, dye = new_scene_arrays(x_res, y_res)
    # Full-height inflow at the two left columns, rainbow dye ramp (×3 cycles).
    bc[:2, :] = [1.0, 0.0]
    mask[:2, :] = 2
    ramp = color_ramp([_CYAN, _RED, _BLUE, _YELLOW] * 3, y_res)
    dye[:2, :] = np.stack((ramp, ramp), axis=0)
    # Outflow at the last column.
    bc[-1, :] = 0.0
    mask[-1, :] = 3
    # Channel walls top/bottom + a cylinder at a quarter length.
    paint_box(bc, mask, dye, (0, 0), (x_res, 2))
    paint_box(bc, mask, dye, (0, y_res - 2), (x_res, y_res))
    paint_circle(bc, mask, dye, (x_res // 4, y_res // 2), y_res // 18)
    return bc, mask, dye


def _scene2(x_res: int, y_res: int):
    bc, mask, dye = new_scene_arrays(x_res, y_res)
    # Inflow: left columns, striped two-tone dye.
    bc[:2, :] = [1.0, 0.0]
    mask[:2, :] = 2
    dye[:2, :] = [0.2, 0.2, 1.2]
    stripe = y_res // 10
    for j0 in range(0, y_res, stripe):
        dye[:2, j0 : j0 + stripe // 2] = [1.2, 1.2, 0.2]
    # Walls: box edges (left split around inflow) + four slalom baffles.
    paint_box(bc, mask, dye, (0, 0), (2, y_res // 3))
    paint_box(bc, mask, dye, (0, 2 * y_res // 3), (2, y_res))
    paint_box(bc, mask, dye, (x_res - 2, 0), (x_res, y_res))
    paint_box(bc, mask, dye, (0, 0), (x_res, 2))
    paint_box(bc, mask, dye, (0, y_res - 2), (x_res, y_res))
    xp, yp, size = x_res // 5, y_res // 2, y_res // 32
    paint_box(bc, mask, dye, (xp - size, yp), (xp + size, y_res))
    paint_box(bc, mask, dye, (2 * xp - size, 0), (2 * xp + size, yp))
    paint_box(bc, mask, dye, (3 * xp - size, yp), (3 * xp + size, y_res))
    paint_box(bc, mask, dye, (4 * xp - size, 0), (4 * xp + size, yp))
    # Outflow: middle third of the right edge, two columns (over the wall).
    bc[-2:, y_res // 3 : 2 * y_res // 3] = 0.0
    mask[-2:, y_res // 3 : 2 * y_res // 3] = 3
    return bc, mask, dye


def _scene3(x_res: int, y_res: int):
    bc, mask, dye = new_scene_arrays(x_res, y_res)
    bc[:2, :] = [1.0, 0.0]
    mask[:2, :] = 2
    ramp = color_ramp([_CYAN, _RED, _BLUE, _YELLOW], y_res)
    dye[:2, :] = np.stack((ramp, ramp), axis=0)
    bc[-1, :] = 0.0
    mask[-1, :] = 3
    paint_box(bc, mask, dye, (0, 0), (x_res, 2))
    paint_box(bc, mask, dye, (0, y_res - 2), (x_res, y_res))
    # 100 random cylinder candidates, reproducible via the reference's seed.
    ref_resolution = 500
    rng_points = _scene3_points(x_res, y_res)
    radius = 16 * (y_res / ref_resolution)
    for point in rng_points:
        paint_circle(bc, mask, dye, point, radius)
    return bc, mask, dye


def _scene3_points(x_res: int, y_res: int):
    """The reference uses the legacy global NumPy RNG with seed 123
    (``fs/boundary_condition.py:353-355``); reproduce the exact stream."""
    rs = np.random.RandomState(123)
    points = rs.uniform(0, x_res, (100, 2))
    return points[points[:, 1] < y_res]


def _scene4(x_res: int, y_res: int):
    bc, mask, dye = new_scene_arrays(x_res, y_res)
    # Closed box first; inflow/outflow carve into the walls.
    paint_box(bc, mask, dye, (0, 0), (2, y_res))
    paint_box(bc, mask, dye, (x_res - 2, 0), (x_res, y_res))
    paint_box(bc, mask, dye, (0, 0), (x_res, 2))
    paint_box(bc, mask, dye, (0, y_res - 2), (x_res, y_res))
    ramp = color_ramp([_CYAN, _RED, _BLUE, _YELLOW], y_res // 4 - 2)
    dye[:2, 3 * y_res // 4 : -2] = np.stack((ramp, ramp), axis=0)
    dye[:2, 2 : y_res // 4] = np.stack((ramp, ramp), axis=0)
    bc[:2, 3 * y_res // 4 : -2] = [1.0, 0.0]
    mask[:2, 3 * y_res // 4 : -2] = 2
    bc[:2, 2 : y_res // 4] = [1.0, 0.0]
    mask[:2, 2 : y_res // 4] = 2
    bc[-2:, 3 * y_res // 8 : 5 * y_res // 8] = 0.0
    mask[-2:, 3 * y_res // 8 : 5 * y_res // 8] = 3
    return bc, mask, dye


def _scene5(x_res: int, y_res: int):
    bc, mask, dye = new_scene_arrays(x_res, y_res)
    # Split inflow on the left edge with red / cyan dyes.
    bc[:2, 2 : y_res // 3] = [1.0, 0.0]
    mask[:2, 2 : y_res // 3] = 2
    dye[:2, 2 : y_res // 3] = [1.2, 0.2, 0.2]
    bc[:2, 2 * y_res // 3 : y_res - 2] = [1.0, 0.0]
    mask[:2, 2 * y_res // 3 : y_res - 2] = 2
    dye[:2, 2 * y_res // 3 : y_res - 2] = [0.2, 1.2, 1.2]
    # Full right-edge outflow.
    bc[-2:, :] = 0.0
    mask[-2:, :] = 3
    # Channel walls + center dividers.
    paint_box(bc, mask, dye, (0, 0), (x_res, 2))
    paint_box(bc, mask, dye, (0, y_res - 2), (x_res, y_res))
    size = x_res // 64
    paint_box(bc, mask, dye, (0, y_res // 5), (11 * x_res // 30, 4 * y_res // 5))
    paint_box(bc, mask, dye, (x_res // 2 - size, 0), (x_res // 2 + size, 2 * y_res // 5))
    paint_box(bc, mask, dye, (x_res // 2 - size, 3 * y_res // 5), (x_res // 2 + size, y_res))
    # Staggered obstacle columns.
    y_point = y_res // 6
    half = np.array([y_res, y_res]) // 25
    for a, b in zip((7, 8, 9, 10, 11), (0, 1, 0, 1, 0)):
        for k in range(1, 6 + b):
            p = np.array([a * x_res // 12, k * y_point - b * y_res // 12])
            paint_box(bc, mask, dye, p - half, p + half)
    return bc, mask, dye


def _scene6(x_res: int, y_res: int):
    return _image_scene(x_res, y_res, ASSET_DIR / "dragon.png")


def _image_scene(x_res: int, y_res: int, image_path) -> tuple:
    """Scene-6 layout with an arbitrary obstacle silhouette image —
    generalizes the reference's hardwired dragon (rabbit.png and
    aircraft.png ship as assets, any grayscale image works)."""
    bc, mask, dye = new_scene_arrays(x_res, y_res)
    bc[:2, :] = [1.0, 0.0]
    mask[:2, :] = 2
    ramp = color_ramp([_CYAN, _RED, _BLUE, _YELLOW], y_res)
    dye[:2, :] = np.stack((ramp, ramp), axis=0)
    bc[-1, :] = 0.0
    mask[-1, :] = 3
    paint_box(bc, mask, dye, (0, 0), (x_res, 2))
    paint_box(bc, mask, dye, (0, y_res - 2), (x_res, y_res))
    paint_mask_image(bc, mask, dye, image_path)
    return bc, mask, dye


SCENE_BUILDERS = {1: _scene1, 2: _scene2, 3: _scene3, 4: _scene4, 5: _scene5, 6: _scene6}


def build_scene_arrays(num: int, resolution: int, mask_image=None):
    """Raw (bc, bc_mask, bc_dye) NumPy arrays for scene `num` at y-resolution
    `resolution`; the grid is (2·resolution, resolution) like the reference
    (``fs/boundary_condition.py:201-219``). `mask_image` (a path) replaces
    scene 6's obstacle silhouette — or names a bundled asset
    ("dragon", "rabbit", "aircraft")."""
    if mask_image is not None:
        path = Path(mask_image)
        if not path.suffix:
            path = ASSET_DIR / f"{mask_image}.png"
        return _image_scene(2 * resolution, resolution, path)
    if num not in SCENE_BUILDERS:
        msg = f"Unknown boundary-condition scene: {num} (valid: 1..6)"
        raise ValueError(msg)
    return SCENE_BUILDERS[num](2 * resolution, resolution)
