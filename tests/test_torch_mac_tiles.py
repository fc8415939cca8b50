"""The tiling rules of the fused MAC kernels, held on the CPU.

``csrc/mac_phases.cu`` runs each MAC phase as one launch: a block owns a
TX × TY tile of output cells.

The dye phase (B3) copies each dye channel into a window one cell (upwind)
or two (KK) wider than the tile on every side, applying the inflow BC on
read at each entry's clamped cell, so an entry outside the grid holds the
BC'd value at the clamped cell. The advection then reads only that window,
and the velocity, the fluid mask and the old alternate only at the tile's
own cells.

The velocity phase (B2) copies both velocity channels, before the BC, into
windows on the tile + (H + 2), H = 1 (upwind) or 2 (KK), since the BC's
ghost mirrors read two cells away; it evaluates the velocity BC into
windows on the tile + H, each entry at its clamped cell with that cell's
code, then runs the momentum update on the tile from those windows and the
pressure on the tile + 1; the old alternate is read at the tile's cells.

This file emulates both evaluations with the port's eager ops on window
tensors, tile by tile, and holds the assembled outputs to
``mac_dye_phase_plain`` and ``mac_velocity_phase_plain`` bit for bit, for
both schemes, at float32 and bf16, on ragged and whole grids, for tiles
smaller than, aligned with and larger than the grid, on scenes 2, 3 and 1
and an open scene (fluid to the grid's edge; for the dye, inflow along its
edge; for the velocity, every velocity BC code 1..6 along its first and
last rows and columns). The negative controls must differ: for the dye, a
halo one cell short for each scheme and, on the open scene, window entries
past the grid left without the BC; for the velocity, a pre-BC window one
cell short for each scheme, a BC'd window one cell short, and on the open
scene the entries past the grid left without the BC. The emulation lives
here, not in the package: it checks the design before and beside the card.

Inputs are seeded NumPy arrays; no card, no JAX.
"""

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch import SimConfig, get_scene, scene_for_dtype
from fluid2d_tpu_torch.ops.advection import advect_kk, advect_upwind
from fluid2d_tpu_torch.ops.cip import diff2_sum
from fluid2d_tpu_torch.ops.cuda_phases import mac_dye_phase_plain, mac_velocity_phase_plain
from fluid2d_tpu_torch.ops.limiters import clamp_field
from fluid2d_tpu_torch.ops.stencil import diff_x, diff_y
from fluid2d_tpu_torch.scenes.runtime_bc import velocity_bc
from fluid2d_tpu_torch.utils.dtypes import f32

torch.set_num_threads(1)

HALO = {"upwind": 1, "kk": 2}  # the dye window's width beyond the tile, each side
ADVECT = {"upwind": advect_upwind, "kk": advect_kk}
GRIDS = {"74x37": 37, "128x64": 64}  # resolution → a (2·res, res) grid
TILES = [(4, 8), (8, 32), (256, 128)]  # the last is larger than either grid
SCENES = {"scene2": 2, "scene3": 3, "scene1": 1, "open": None}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _open(scene):
    """`scene` with fluid to the grid's edge and inflow along its first and
    last rows and its first column: the BC'd values at the clamped cells
    decide the edge cells' outputs, which the shipped scenes' walls keep
    away from the edge."""
    x, y = scene.shape
    inflow = torch.zeros((x, y), dtype=torch.bool)
    inflow[0], inflow[-1], inflow[:, 0] = True, True, True
    fluid = torch.ones((x, y), dtype=torch.bool)
    return scene._replace(fluid=fluid, fluid8=fluid.to(torch.int8), inflow=inflow,
                          inflow8=inflow.to(torch.int8))


def _inputs(bc_num, res: int, dtype: torch.dtype):
    """Scene and seeded (dye, dye_alt, vel, scene, dt, dx) in `dtype`."""
    cfg = SimConfig.create(resolution=res, re=1000.0, dtype=str(dtype).removeprefix("torch."))
    scene = scene_for_dtype(get_scene(2 if bc_num is None else bc_num, res, "cpu"), cfg)
    if bc_num is None:
        scene = _open(scene)
    rng = np.random.default_rng(100 * (bc_num or 9) + res)

    def rnd(lead, scale, offset=0.0):
        a = offset + scale * rng.standard_normal((*lead, *scene.shape)).astype(np.float32)
        return torch.from_numpy(a).to(dtype)

    # |v|·dt/dx of a few tenths, so that the advection moves the dye visibly
    return rnd((3,), 0.5, 0.5), rnd((3,), 0.5, 0.5), rnd((2,), 30.0), scene, cfg.dt, cfg.dx


class _Tile:
    """Window geometry of the tile at (ti, tj): clamped cell coordinates of
    the window `h` cells beyond it, and gathers of whole fields at them."""

    def __init__(self, shape, ti, tj, tx, ty):
        self.shape, self.ti, self.tj, self.tx, self.ty = shape, ti, tj, tx, ty

    def positions(self, h):
        """Rows and columns of the window `h` cells beyond the tile."""
        return (torch.arange(self.ti - h, self.ti + self.tx + h),
                torch.arange(self.tj - h, self.tj + self.ty + h))

    def gather(self, field, h):
        rows, cols = self.positions(h)
        x, y = self.shape
        return field[..., rows.clamp(0, x - 1), :][..., cols.clamp(0, y - 1)]

    def reclamp(self, win, h):
        """Each entry of a window computed position by position (the window
        `h` cells beyond the tile) replaced by the entry at its clamped
        cell: the value computed there."""
        rows, cols = self.positions(h)
        x, y = self.shape
        r = rows.clamp(0, x - 1) - (self.ti - h)
        c = cols.clamp(0, y - 1) - (self.tj - h)
        return win[..., r, :][..., c]

    def inside(self, h):
        """True at the window's entries whose position lies in the grid."""
        rows, cols = self.positions(h)
        x, y = self.shape
        return ((rows >= 0) & (rows < x))[:, None] & ((cols >= 0) & (cols < y))[None, :]


def _crop(win, n):
    return win[..., n:-n, n:-n] if n else win


def _short(win, short):
    """The window with its outermost `short` rings replaced by the nearest
    entry inside them: what the advection reads if the halo is `short`
    cells too narrow and its reads clamp at the window's edge."""
    if short == 0:
        return win
    h, w = win.shape[-2:]
    r = torch.arange(h).clamp(short, h - 1 - short)
    c = torch.arange(w).clamp(short, w - 1 - short)
    return win[..., r, :][..., c]


def _fused_tile(t, dye, dye_alt, vel, scene, scheme, dt, dx, short=0, bc_inside_only=False):
    """One tile's (dye_cur, dc), float32 and tile-shaped, by the fused rule.
    `bc_inside_only` (the negative control) leaves the entries past the grid
    without the BC: the dye at the clamped cell as it was before the BC."""
    h = HALO[scheme]
    # the window: the inflow BC applied on read, at each entry's clamped cell
    inflow = t.gather(scene.inflow, h)
    if bc_inside_only:
        inflow = inflow & t.inside(h)
    win = torch.where(inflow, t.gather(scene.bc_dye, h), t.gather(f32(dye), h))
    win = _short(win, short)
    # the velocity on the window too, but only the tile's cells reach the outputs
    u, w = t.gather(f32(vel), h)
    adv = _crop(ADVECT[scheme](u, w, win, dx), h)
    dc = _crop(win, h)
    cur = torch.where(t.gather(scene.fluid, 0), dc - dt * adv, t.gather(f32(dye_alt), 0))
    return clamp_field(cur, 0.0, 1.0), dc


def fused_dye_phase(args, scheme, tile, **rule):
    """The phase's two outputs assembled tile by tile, each rounded once to
    the storage dtype as the kernel's stores round."""
    dye, dye_alt, vel, scene, dt, dx = args
    x, y = scene.shape
    tx, ty = tile
    outs = [torch.empty_like(dye) for _ in range(2)]
    for ti in range(0, x, tx):
        for tj in range(0, y, ty):
            got = _fused_tile(_Tile((x, y), ti, tj, tx, ty), dye, dye_alt, vel, scene, scheme,
                              dt, dx, **rule)
            rows, cols = min(tx, x - ti), min(ty, y - tj)
            for o, g in zip(outs, got):
                o[:, ti:ti + rows, tj:tj + cols] = g[:, :rows, :cols].to(o.dtype)
    return tuple(outs)


def _plain(args, scheme):
    dye, dye_alt, vel, scene, dt, dx = args
    return mac_dye_phase_plain(dye, dye_alt, vel, scene, scheme, dt, dx)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _equal(got, ref) -> bool:
    return all(g.dtype == r.dtype and torch.equal(_bits(g), _bits(r)) for g, r in zip(got, ref))


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("tile", TILES, ids=[f"{a}x{b}" for a, b in TILES])
@pytest.mark.parametrize("res", GRIDS.values(), ids=GRIDS.keys())
@pytest.mark.parametrize("bc_num", SCENES.values(), ids=SCENES.keys())
@pytest.mark.parametrize("scheme", HALO)
def test_fused_dye_tiles_bit_equal_to_plain(scheme, bc_num, res, tile, dtype):
    args = _inputs(bc_num, res, dtype)
    got = fused_dye_phase(args, scheme, tile)
    ref = _plain(args, scheme)
    assert _equal(got, ref), [int((_bits(g) != _bits(r)).sum()) for g, r in zip(got, ref)]


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("scheme", HALO)
def test_halo_one_cell_short_differs(scheme, dtype):
    """The window one cell narrower than the scheme's reach changes the
    clamped dye (the BC'd alternate is read at the tile's cells only, so
    it stays)."""
    args = _inputs(2, 37, dtype)
    ref = _plain(args, scheme)
    assert _equal(fused_dye_phase(args, scheme, (8, 32)), ref)
    short = fused_dye_phase(args, scheme, (8, 32), short=1)
    assert not torch.equal(_bits(short[0]), _bits(ref[0]))
    assert torch.equal(_bits(short[1]), _bits(ref[1]))


@pytest.mark.parametrize("scheme", HALO)
def test_open_scene_needs_the_bc_past_the_grid(scheme):
    """On the open scene the edge cells' outputs read window entries past
    the grid: entries without the BC there (the pre-BC dye at the clamped
    cell) must change the clamped dye, and only at the edge cells."""
    args = _inputs(None, 37, torch.float32)
    ref = _plain(args, scheme)
    assert _equal(fused_dye_phase(args, scheme, (8, 32)), ref)
    got = fused_dye_phase(args, scheme, (8, 32), bc_inside_only=True)
    moved = (_bits(got[0]) != _bits(ref[0])).any(0)
    edge = torch.ones_like(moved)
    edge[2:-2, 2:-2] = False
    assert bool(moved.any()) and not bool((moved & ~edge).any())
    assert torch.equal(_bits(got[1]), _bits(ref[1]))


# --- the velocity phase (B2) ---------------------------------------------------------


def _open_velocity(scene, rng, dtype):
    """`scene` with fluid to the grid's edge and the velocity BC codes 1..6
    in turn along its first and last rows and columns (0 inside), with
    seeded inflow velocities: the BC'd values at the clamped cells, ghost
    mirrors two cells in and the outflow rule one cell upstream, decide the
    edge cells' outputs."""
    x, y = scene.shape
    code = torch.zeros((x, y), dtype=torch.int8)
    cyc = torch.arange(2 * (x + y)) % 6 + 1
    code[0], code[-1] = cyc[:y], cyc[1:y + 1]
    code[:, 0], code[:, -1] = cyc[2:x + 2], cyc[3:x + 3]
    fluid = torch.ones((x, y), dtype=torch.bool)
    bc_const = torch.from_numpy(rng.standard_normal((2, x, y)).astype(np.float32)).to(dtype)
    return scene._replace(vbc_code=code, vbc_targets=torch.stack([code == k for k in range(1, 5)]),
                          inflow=code == 5, outflow=code == 6, fluid=fluid,
                          fluid8=fluid.to(torch.int8), bc_const=bc_const)


def _velocity_inputs(bc_num, res: int, dtype: torch.dtype):
    """Seeded (v, p, v_alt, scene, re, dt, dx) in `dtype`."""
    cfg = SimConfig.create(resolution=res, re=1000.0, dtype=str(dtype).removeprefix("torch."))
    scene = scene_for_dtype(get_scene(2 if bc_num is None else bc_num, res, "cpu"), cfg)
    rng = np.random.default_rng(200 * (bc_num or 9) + res)
    if bc_num is None:
        scene = _open_velocity(scene, rng, dtype)

    def rnd(lead, scale):
        a = scale * rng.standard_normal((*lead, *scene.shape)).astype(np.float32)
        return torch.from_numpy(a).to(dtype)

    return rnd((2,), 3.0), rnd((), 0.3), rnd((2,), 0.5), scene, cfg.re, cfg.dt, cfg.dx


class _WindowScene:
    """The scene leaves ``velocity_bc`` reads, gathered on a window."""

    def __init__(self, t, scene, h):
        self.vbc_targets = t.gather(scene.vbc_targets, h)
        self.inflow = t.gather(scene.inflow, h)
        self.outflow = t.gather(scene.outflow, h)
        self.bc_const = t.gather(f32(scene.bc_const), h)


def _fused_velocity_tile(t, v, p, v_alt, scene, scheme, re, dt, dx, short_pre=0, short_bc=0,
                         bc_inside_only=False):
    """One tile's (v_cur, vc), float32 and tile-shaped, by the fused rule:
    the BC evaluated on the window + H at each entry's clamped cell from the
    pre-BC window + (H + 2). `short_pre`, `short_bc` (negative controls)
    narrow a window by that many cells; `bc_inside_only` leaves the entries
    past the grid without the BC (the pre-BC velocity at the clamped cell)."""
    h = HALO[scheme]
    pre = _short(t.gather(f32(v), h + 2), short_pre)
    vc = t.reclamp(_crop(velocity_bc(pre, _WindowScene(t, scene, h + 2)), 2), h)
    if bc_inside_only:
        vc = torch.where(t.inside(h), vc, _crop(pre, 2))
    vc = _short(vc, short_bc)
    pw = t.gather(f32(p), 1)
    rhs = (
        -_crop(ADVECT[scheme](vc[0], vc[1], vc, dx), h)
        - _crop(torch.stack([diff_x(pw, dx), diff_y(pw, dx)]), 1)
        + _crop(diff2_sum(vc, dx), h) / re
    )
    cur = torch.where(t.gather(scene.fluid, 0), _crop(vc, h) + dt * rhs, t.gather(f32(v_alt), 0))
    return cur, _crop(vc, h)


def fused_velocity_phase(args, scheme, tile, **rule):
    """The phase's two outputs assembled tile by tile, each rounded once to
    the storage dtype as the kernel's stores round."""
    v, p, v_alt, scene, re, dt, dx = args
    x, y = scene.shape
    tx, ty = tile
    outs = [torch.empty_like(v) for _ in range(2)]
    for ti in range(0, x, tx):
        for tj in range(0, y, ty):
            got = _fused_velocity_tile(_Tile((x, y), ti, tj, tx, ty), v, p, v_alt, scene, scheme,
                                       re, dt, dx, **rule)
            rows, cols = min(tx, x - ti), min(ty, y - tj)
            for o, g in zip(outs, got):
                o[:, ti:ti + rows, tj:tj + cols] = g[:, :rows, :cols].to(o.dtype)
    return tuple(outs)


def _plain_velocity(args, scheme):
    v, p, v_alt, scene, re, dt, dx = args
    return mac_velocity_phase_plain(v, p, v_alt, scene, scheme, re, dt, dx)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("tile", TILES, ids=[f"{a}x{b}" for a, b in TILES])
@pytest.mark.parametrize("res", GRIDS.values(), ids=GRIDS.keys())
@pytest.mark.parametrize("bc_num", SCENES.values(), ids=SCENES.keys())
@pytest.mark.parametrize("scheme", HALO)
def test_fused_velocity_tiles_bit_equal_to_plain(scheme, bc_num, res, tile, dtype):
    args = _velocity_inputs(bc_num, res, dtype)
    got = fused_velocity_phase(args, scheme, tile)
    ref = _plain_velocity(args, scheme)
    assert _equal(got, ref), [int((_bits(g) != _bits(r)).sum()) for g, r in zip(got, ref)]


# negative controls: (scheme, scene, rule). A pre-BC window one cell short
# reaches the BC's ghost mirrors two cells in, which the open scene puts at
# every tile's edge along the grid's.
VELOCITY_CONTROLS = {
    "pre_bc_short_upwind_open": ("upwind", None, {"short_pre": 1}),
    "pre_bc_short_kk_open": ("kk", None, {"short_pre": 1}),
    "pre_bc_short_kk_scene2": ("kk", 2, {"short_pre": 1}),
    "bc_short_upwind_scene2": ("upwind", 2, {"short_bc": 1}),
    "bc_short_kk_scene2": ("kk", 2, {"short_bc": 1}),
    "bc_inside_only_upwind_open": ("upwind", None, {"bc_inside_only": True}),
    "bc_inside_only_kk_open": ("kk", None, {"bc_inside_only": True}),
}


@pytest.mark.parametrize("control", VELOCITY_CONTROLS)
def test_velocity_negative_control_differs(control):
    """Each control changes the updated velocity and leaves the BC'd
    alternate, which the tile's cells read from the pre-BC window no more
    than two cells away, as it was."""
    scheme, bc_num, rule = VELOCITY_CONTROLS[control]
    args = _velocity_inputs(bc_num, 37, torch.float32)
    ref = _plain_velocity(args, scheme)
    assert _equal(fused_velocity_phase(args, scheme, (8, 32)), ref)
    got = fused_velocity_phase(args, scheme, (8, 32), **rule)
    assert not torch.equal(_bits(got[0]), _bits(ref[0]))
    assert torch.equal(_bits(got[1]), _bits(ref[1]))
