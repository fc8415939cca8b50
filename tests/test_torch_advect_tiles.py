"""The tiling rule of the standalone CIP advection kernel (C1), held on the CPU.

``csrc/cip_phases.cu`` runs C1 as one launch of ``cip_advect_fused_kernel``:
a block owns a TX × TY tile of every channel. It fills the carrying
velocity's two planes on the tile + 1 once, then each channel's f, fx and fy
on the tile + 1, a window entry outside the grid holding the value at the
clamped cell, and runs the CIP advection cell on those windows; the
alternates are read at the non-fluid cells of the tile only. When the
velocity advects itself (``vel is f``) the velocity's windows are channels 0
and 1's f windows. This file emulates that evaluation with the port's eager
``cip_advect`` on window tensors, tile by tile and channel by channel, and
holds the assembled outputs to ``cip_advect_plain`` bit for bit, at float32
and bf16, in both forms, on scenes 1–3 and an open scene (fluid on every
edge cell), on grids whose X and Y are not multiples of the kernel's 32×32
tile and whose Y is not a multiple of 4 (the fills' element-by-element
edge). Controls: a window one cell short differs, and entries past the grid
that do not hold the clamped cell's value differ on the open scene (and only
there: no shipped scene has a fluid cell on its edge). The emulation lives
here, not in the package: it checks the design before and beside the card.

Inputs are seeded NumPy arrays; no card, no JAX.
"""

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch import SimConfig, get_scene
from fluid2d_tpu_torch.ops.cip import cip_advect
from fluid2d_tpu_torch.ops.cuda_stencil import cip_advect_plain
from fluid2d_tpu_torch.utils.dtypes import f32

torch.set_num_threads(1)

GRIDS = {"74x37": 37, "100x50": 50}  # resolution → a (2·res, res) grid
TILES = [(32, 32), (8, 16)]  # the kernel's tile, and one with more tile edges
SCENES = {"scene1": 1, "scene2": 2, "scene3": 3, "open": None}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
FORMS = {"dye_form": False, "velocity_form": True}


def _inputs(bc, res: int, dtype: torch.dtype, self_advect: bool):
    """Seeded arguments of cip_advect_plain on scene `bc` (None: the open
    scene) at `res`: the dye form (C = 3, a separate velocity) or the
    velocity form (C = 2, vel is f)."""
    cfg = SimConfig.create(resolution=res)
    shape = (2 * res, res)
    rng = np.random.default_rng(10 * res + (bc or 0) + 5 * self_advect)
    if bc is None:
        fluid = rng.random(shape) > 0.2
        fluid[0] = fluid[-1] = fluid[:, 0] = fluid[:, -1] = True
        fluid8 = torch.from_numpy(fluid.astype(np.int8))
    else:
        fluid8 = get_scene(bc, res, "cpu").fluid8

    def rnd(chans, scale):
        a = scale * rng.standard_normal((chans, *shape)).astype(np.float32)
        return torch.from_numpy(a).to(dtype)

    chans = 2 if self_advect else 3
    f, fx, fy = rnd(chans, 8.0 if self_advect else 0.5), rnd(chans, 0.1), rnd(chans, 0.1)
    vel = f if self_advect else rnd(2, 8.0)
    alts = [rnd(chans, 0.5) for _ in range(3)]
    return (f, fx, fy, vel, *alts, fluid8, cfg.dt, cfg.dx)


def _window(field, ti, tj, tx, ty, short: bool = False, unclamped: bool = False):
    """`field` (..., X, Y) as float32 on the tile at (ti, tj) + 1, each entry
    at its clamped cell. short: the outermost ring replaced by the nearest
    entry inside it (a halo one cell too narrow, read clamped at the
    window's edge); unclamped: entries outside the grid 0."""
    x, y = field.shape[-2:]
    rows = torch.arange(ti - 1, ti + tx + 1)
    cols = torch.arange(tj - 1, tj + ty + 1)
    win = f32(field)[..., rows.clamp(0, x - 1), :][..., cols.clamp(0, y - 1)]
    if unclamped:
        inside = ((rows >= 0) & (rows < x))[:, None] & ((cols >= 0) & (cols < y))[None, :]
        win = torch.where(inside, win, torch.zeros_like(win))
    if short:
        r = torch.arange(win.shape[-2]).clamp(1, win.shape[-2] - 2)
        c = torch.arange(win.shape[-1]).clamp(1, win.shape[-1] - 2)
        win = win[..., r, :][..., c]
    return win


def fused_advect(args, tile, **control):
    """C1's three outputs assembled tile by tile as the kernel computes
    them, each rounded once to the storage dtype."""
    f, fx, fy, vel, alt_f, alt_fx, alt_fy, fluid8, dt, dx = args
    chans, x, y = f.shape
    tx, ty = tile
    outs = [torch.empty_like(f) for _ in range(3)]
    for ti in range(0, x, tx):
        for tj in range(0, y, ty):
            rows, cols = min(tx, x - ti), min(ty, y - tj)
            cut = (..., slice(ti, ti + rows), slice(tj, tj + cols))
            uw = _window(vel[:2], ti, tj, tx, ty, **control)  # once a tile
            fluid = fluid8[cut[1:]] != 0
            for ch in range(chans):
                fw = uw[ch] if vel is f and ch < 2 else _window(f[ch], ti, tj, tx, ty, **control)
                gx, gy = (_window(g[ch], ti, tj, tx, ty, **control) for g in (fx, fy))
                cand = cip_advect(fw, gx, gy, uw[0], uw[1], dt, dx)
                for o, c, alt in zip(outs, cand, (alt_f, alt_fx, alt_fy)):
                    got = torch.where(fluid, c[1:1 + rows, 1:1 + cols], f32(alt[ch][cut[1:]]))
                    o[ch][cut[1:]] = got.to(o.dtype)
    return tuple(outs)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _equal(got, ref) -> bool:
    return all(g.dtype == r.dtype and torch.equal(_bits(g), _bits(r)) for g, r in zip(got, ref))


@pytest.mark.parametrize("self_advect", FORMS.values(), ids=FORMS.keys())
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("tile", TILES, ids=[f"{a}x{b}" for a, b in TILES])
@pytest.mark.parametrize("res", GRIDS.values(), ids=GRIDS.keys())
@pytest.mark.parametrize("bc", SCENES.values(), ids=SCENES.keys())
def test_tiled_advection_bit_equal_to_plain(bc, res, tile, dtype, self_advect):
    args = _inputs(bc, res, dtype, self_advect)
    ref = cip_advect_plain(*args)
    got = fused_advect(args, tile)
    assert _equal(got, ref), [int((_bits(g) != _bits(r)).sum()) for g, r in zip(got, ref)]


@pytest.mark.parametrize("self_advect", FORMS.values(), ids=FORMS.keys())
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_window_one_cell_short_differs(dtype, self_advect):
    args = _inputs(None, 37, dtype, self_advect)
    ref = cip_advect_plain(*args)
    assert _equal(fused_advect(args, (32, 32)), ref)
    assert not _equal(fused_advect(args, (32, 32), short=True), ref)


@pytest.mark.parametrize("self_advect", FORMS.values(), ids=FORMS.keys())
@pytest.mark.parametrize("bc", SCENES.values(), ids=SCENES.keys())
def test_entries_past_the_grid_matter_on_the_open_scene_only(bc, self_advect):
    """Window entries outside the grid that do not hold the clamped cell's
    value change the outputs where fluid reaches the grid's edge (the open
    scene), and nowhere on the shipped scenes."""
    args = _inputs(bc, 37, torch.float32, self_advect)
    ref = cip_advect_plain(*args)
    assert _equal(fused_advect(args, (32, 32), unclamped=True), ref) == (bc is not None)
