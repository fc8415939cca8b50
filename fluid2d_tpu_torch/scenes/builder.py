"""Host-side scene geometry primitives (NumPy; port of
``fluid2d_tpu/scenes/builder.py``).

Produces the three static scene arrays in reference layout —
``bc`` (X, Y, 2) imposed velocity, ``bc_mask`` (X, Y) uint8 with codes
0=fluid / 1=wall / 2=inflow / 3=outflow, ``bc_dye`` (X, Y, 3) — matching
the reference simulator's ``fs/boundary_condition.py:115-198`` cell-for-cell.

Only the NumPy paths are carried over. The JAX package's native C++
rasterizer is bit-identical to them (its own tests check that), and
reaching it would import the JAX package. The obstacle images are read
from the JAX package's asset folder by path, not copied.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import numpy.typing as npt

__all__ = [
    "ASSET_DIR",
    "new_scene_arrays",
    "color_ramp",
    "paint_circle",
    "paint_box",
    "paint_mask_image",
]

ASSET_DIR = Path(__file__).resolve().parents[2] / "fluid2d_tpu" / "scenes" / "assets"


def new_scene_arrays(x_res: int, y_res: int):
    """Zero-initialized (bc, bc_mask, bc_dye) arrays
    (parity: ``fs/boundary_condition.py:115-122``)."""
    bc = np.zeros((x_res, y_res, 2), dtype=np.float32)
    bc_mask = np.zeros((x_res, y_res), dtype=np.uint8)
    bc_dye = np.zeros((x_res, y_res, 3), dtype=np.float32)
    return bc, bc_mask, bc_dye


def color_ramp(colors: list[npt.NDArray], n_samples: int) -> npt.NDArray:
    """Piecewise-linear RGB ramp through `colors`, sampled at `n_samples`
    points (parity: ``create_color_map``, ``fs/boundary_condition.py:125-134``)."""
    color_arr = np.vstack(colors)
    x = np.linspace(0.0, 1.0, color_arr.shape[0], endpoint=True)
    xq = np.linspace(0.0, 1.0, n_samples, endpoint=True)
    channels = [np.interp(xq, x, color_arr[:, k]) for k in range(3)]
    return np.vstack(channels).T


def paint_circle(bc, bc_mask, bc_dye, center, radius: float) -> None:
    """Mark a solid circular wall (parity: ``set_circle``,
    ``fs/boundary_condition.py:137-154``).

    A cell (i, j) becomes wall iff it lies in the reference's candidate
    box [round(max(c-r,0)), round(min(c+r, shape))) and the cell center
    (i+0.5, j+0.5) is strictly inside the circle. ``round`` is
    round-half-to-even in both NumPy and the reference's Python ``round``.
    """
    center_arr = np.asarray(center, dtype=np.float64)
    lo = np.round(np.maximum(center_arr - radius, 0)).astype(np.int64)
    u0 = round(min(center[0] + radius, bc.shape[0]))
    u1 = round(min(center[1] + radius, bc.shape[1]))
    if u0 <= lo[0] or u1 <= lo[1]:
        return
    ii, jj = np.meshgrid(np.arange(lo[0], u0), np.arange(lo[1], u1), indexing="ij")
    dx = ii + 0.5 - center[0]
    dy = jj + 0.5 - center[1]
    # sqrt of sum of squares, matching the reference's np.linalg.norm
    # (np.hypot can differ by an ulp at knife-edge cells).
    inside = np.sqrt(dx * dx + dy * dy) < radius
    sub = (slice(lo[0], u0), slice(lo[1], u1))
    bc[sub][inside] = 0.0
    bc_mask[sub][inside] = 1
    bc_dye[sub][inside] = 0.0


def paint_box(bc, bc_mask, bc_dye, lower_left, upper_right) -> None:
    """Mark an axis-aligned rectangular wall (parity: ``set_plane``,
    ``fs/boundary_condition.py:157-168``)."""
    sub = (slice(lower_left[0], upper_right[0]), slice(lower_left[1], upper_right[1]))
    bc[sub] = 0.0
    bc_mask[sub] = 1
    bc_dye[sub] = 0.0


def paint_mask_image(bc, bc_mask, bc_dye, filepath: Path) -> None:
    """Rasterize an image silhouette into walls (parity:
    ``set_obstacle_fromfile``, ``fs/boundary_condition.py:171-198``).

    Grayscale < 200 becomes wall. The image is resized preserving aspect
    ratio to fit the grid, pasted centered in x / flush-top in y onto a
    white canvas, then transposed and flipped to the grid orientation.
    """
    from PIL import Image

    image = Image.open(filepath).convert("L")
    x_res, y_res = bc.shape[:2]

    x_ratio = x_res / image.width
    y_ratio = y_res / image.height
    if x_ratio < y_ratio:
        resize_size = (x_res, round(image.height * x_ratio))
    else:
        resize_size = (round(image.width * y_ratio), y_res)
    image = image.resize(resize_size)

    canvas = Image.new(image.mode, (x_res, y_res), 255)
    canvas.paste(image, ((x_res - image.width) // 2, 0))

    is_wall = np.flip(np.asarray(canvas).T, axis=1) < 200
    bc[is_wall] = 0.0
    bc_mask[is_wall] = 1
    bc_dye[is_wall] = 0.0
