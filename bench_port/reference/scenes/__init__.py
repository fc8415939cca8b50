"""The scenes of the reference simulator (takah29/2d-fluid-simulator,
``fs/boundary_condition.py``), drawn in NumPy, and the masks the plain step
reads.

A scene is a grid of (2·res) × res cells with a code per cell: 0 fluid,
1 wall, 2 inflow, 3 outflow; an imposed velocity ``bc`` (2, X, Y) and an
inflow dye colour ``dye`` (3, X, Y). Scene ``n`` (the reference's ``-bc n``)
is painted by ``paint(canvas, x_res, y_res)`` in the file ``bc<n>.py`` of
this folder, found by its number: a new scene is a new file.
:func:`derive` adds what the boundary conditions read: the four
ghost-velocity target masks, the pressure pattern code of each cell and the
red-black SOR colours.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

__all__ = ["FOLDER", "Canvas", "ramp", "draw", "derive", "YELLOW", "BLUE", "RED", "CYAN"]

FOLDER = Path(__file__).resolve().parent

YELLOW = (1.1, 1.1, 0.2)
BLUE = (0.2, 0.2, 1.1)
RED = (1.1, 0.2, 0.2)
CYAN = (0.2, 1.1, 1.1)


class Canvas:
    def __init__(self, x_res: int, y_res: int):
        self.bc = np.zeros((x_res, y_res, 2), np.float32)
        self.mask = np.zeros((x_res, y_res), np.uint8)
        self.dye = np.zeros((x_res, y_res, 3), np.float32)

    def box(self, lo, hi) -> None:
        """Wall over [lo, hi) (``set_plane``)."""
        sub = (slice(lo[0], hi[0]), slice(lo[1], hi[1]))
        self.bc[sub], self.mask[sub], self.dye[sub] = 0.0, 1, 0.0

    def circle(self, center, radius) -> None:
        """Wall at the cells whose centres lie strictly inside the circle,
        searched over the reference's rounded box (``set_circle``)."""
        c0, c1 = center
        lo0, lo1 = (int(np.round(max(c - radius, 0))) for c in (c0, c1))
        hi0 = round(min(c0 + radius, self.mask.shape[0]))
        hi1 = round(min(c1 + radius, self.mask.shape[1]))
        if hi0 <= lo0 or hi1 <= lo1:
            return
        ii, jj = np.meshgrid(np.arange(lo0, hi0), np.arange(lo1, hi1), indexing="ij")
        di, dj = ii + 0.5 - c0, jj + 0.5 - c1
        inside = np.sqrt(di * di + dj * dj) < radius
        sub = (slice(lo0, hi0), slice(lo1, hi1))
        self.bc[sub][inside], self.mask[sub][inside], self.dye[sub][inside] = 0.0, 1, 0.0


def ramp(colors, n: int) -> np.ndarray:
    """Piecewise-linear colour ramp through `colors` at n points
    (``create_color_map``)."""
    c = np.asarray(colors, dtype=np.float64)
    x = np.linspace(0.0, 1.0, len(c))
    xq = np.linspace(0.0, 1.0, n)
    return np.stack([np.interp(xq, x, c[:, k]) for k in range(3)], axis=-1)


def _painter(scene: int, folder: Path):
    path = Path(folder) / f"bc{int(scene)}.py"
    if not path.is_file():
        msg = f"no file {path} for scene {scene!r}"
        raise FileNotFoundError(msg)
    spec = importlib.util.spec_from_file_location(f"bench_port_scene_bc{int(scene)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.paint


def draw(scene: int, res: int, folder: Path = FOLDER) -> dict[str, np.ndarray]:
    """Scene `scene` at y-resolution `res`, painted by ``<folder>/bc<scene>.py``:
    ``mask`` (X, Y) uint8, ``bc`` (2, X, Y) and ``dye`` (3, X, Y) float32."""
    cv = Canvas(2 * res, res)
    _painter(scene, folder)(cv, 2 * res, res)
    return {"mask": cv.mask, "bc": np.moveaxis(cv.bc, -1, 0).copy(),
            "dye": np.moveaxis(cv.dye, -1, 0).astype(np.float32)}


def _at(m: np.ndarray, di: int, dj: int) -> np.ndarray:
    """m[clamp(i + di), clamp(j + dj)]."""
    i = np.clip(np.arange(m.shape[0]) + di, 0, m.shape[0] - 1)
    j = np.clip(np.arange(m.shape[1]) + dj, 0, m.shape[1] - 1)
    return m[np.ix_(i, j)]


def derive(mask: np.ndarray) -> dict[str, np.ndarray]:
    """The masks the boundary conditions and the SOR sweeps read.

    ``ghost`` (4, X, Y): an interior wall cell with fluid on one side and
    walls on the two across it triggers (in the order -x, +x, -y, +y, the
    first that holds) a write to the wall cell beyond it, which takes the
    negated velocity two cells back toward the fluid; where two triggers
    target one cell, the later pattern wins. ``pcode`` (X, Y): a wall
    cell's pressure pattern, the first of 1..8 that holds (copy from the
    fluid neighbour at -x, +x, -y, +y; the average of two at a corner);
    9 inflow (copy from +x), 10 outflow (0)."""
    x_res, y_res = mask.shape
    fl = {d: _at(mask, *d) == 0 for d in ((-1, 0), (1, 0), (0, -1), (0, 1))}
    wa = {d: _at(mask, *d) == 1 for d in ((-1, 0), (1, 0), (0, -1), (0, 1))}
    walls_y = wa[(0, -1)] & wa[(0, 1)]
    walls_x = wa[(-1, 0)] & wa[(1, 0)]
    wall = mask == 1
    interior = np.zeros_like(wall)
    interior[1:-1, 1:-1] = True
    conds = [fl[(-1, 0)] & walls_y, fl[(1, 0)] & walls_y,
             fl[(0, -1)] & walls_x, fl[(0, 1)] & walls_x]

    ghost = np.zeros((4, x_res, y_res), bool)
    open_ = wall & interior
    for k, cond in enumerate(conds):
        trig = open_ & cond
        open_ = open_ & ~trig
        di, dj = ((1, 0), (-1, 0), (0, 1), (0, -1))[k]  # the target lies beyond the wall cell
        ghost[k] = _at(trig, -di, -dj) & _shift_valid(x_res, y_res, di, dj)
    pconds = conds + [fl[(-1, 0)] & fl[(0, 1)], fl[(1, 0)] & fl[(0, 1)],
                      fl[(-1, 0)] & fl[(0, -1)], fl[(1, 0)] & fl[(0, -1)]]
    pcode = np.zeros(mask.shape, np.int8)
    undecided = wall.copy()
    for k, cond in enumerate(pconds, start=1):
        hit = undecided & cond
        pcode[hit] = k
        undecided &= ~hit
    pcode[mask == 2] = 9
    pcode[mask == 3] = 10
    odd = (np.add.outer(np.arange(x_res), np.arange(y_res)) % 2) == 1
    fluid = mask == 0
    return {"ghost": ghost, "pcode": pcode, "odd_fluid": fluid & odd, "even_fluid": fluid & ~odd}


def _shift_valid(x_res: int, y_res: int, di: int, dj: int) -> np.ndarray:
    """Cells (i, j) whose source (i - di, j - dj) lies on the grid."""
    ok = np.ones((x_res, y_res), bool)
    if di > 0:
        ok[:di, :] = False
    elif di < 0:
        ok[di:, :] = False
    if dj > 0:
        ok[:, :dj] = False
    elif dj < 0:
        ok[:, dj:] = False
    return ok
