"""The tiling rule of the fused CIP phase kernels, held on the CPU.

``csrc/cip_phases.cu`` runs each CIP phase as one launch: a block owns a
TX × TY tile of output cells and evaluates the cascade on windows one cell
wider on every side than the next stage reads (f_bc on the tile + 3, f_na
+ 2, the gradients + 1, the advection on the tile). A window entry at a cell
outside the grid holds the stage's value at the clamped cell, and the
non-advection and gradient stages take the alternate at wall cells. This file
emulates that evaluation with the port's eager ops on window tensors, tile
by tile, and holds the assembled outputs to ``cip_velocity_phase_plain`` /
``cip_dye_phase_plain`` bit for bit, at float32 and bf16, on ragged and
whole grids, for tiles smaller than, aligned with and larger than the grid,
on scenes 2, 3 (a one-column outflow) and 1 (walls). A halo one cell short
at any stage must differ (the negative control). The emulation lives here,
not in the package: it checks the design before and beside the card.

Inputs are seeded NumPy arrays; no card, no JAX.
"""

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch import SimConfig, get_scene, scene_for_dtype
from fluid2d_tpu_torch.ops.cip import (
    cip_advect,
    non_advection_diffusion,
    non_advection_grad,
    non_advection_velocity,
)
from fluid2d_tpu_torch.ops.cuda_phases import cip_dye_phase_plain, cip_velocity_phase_plain
from fluid2d_tpu_torch.ops.limiters import clamp_field
from fluid2d_tpu_torch.scenes.runtime_bc import dye_bc, velocity_bc
from fluid2d_tpu_torch.utils.dtypes import f32

torch.set_num_threads(1)

HALO = {"bc": 3, "na": 2, "grad": 1}  # window widths beyond the tile, each side
GRIDS = {"74x37": 37, "128x64": 64}  # resolution → a (2·res, res) grid
TILES = [(4, 8), (8, 32), (256, 128)]  # the last is larger than either grid
SCENES = [2, 3, 1]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(bc_num: int, res: int, dtype: torch.dtype):
    """Scene and seeded fields: (scene, cfg, velocity args, dye args)."""
    cfg = SimConfig.create(resolution=res, re=1000.0, dtype=str(dtype).removeprefix("torch."))
    scene = scene_for_dtype(get_scene(bc_num, res, "cpu"), cfg)
    rng = np.random.default_rng(100 * bc_num + res)

    def rnd(lead, scale, offset=0.0):
        a = offset + scale * rng.standard_normal((*lead, *scene.shape)).astype(np.float32)
        return torch.from_numpy(a).to(dtype)

    p, v, v_alt = rnd((), 0.3), rnd((2,), 3.0), rnd((2,), 0.5)
    vg = [rnd((2,), 0.1) for _ in range(4)]
    dye, dg = rnd((3,), 0.5, 0.5), [rnd((3,), 0.1) for _ in range(5)]
    consts = (cfg.re, cfg.dt, cfg.dx)
    return scene, (v, p, v_alt, *vg, scene, *consts), (dye, *dg, v, scene, *consts)


class _Tile:
    """Window geometry of the tile at (ti, tj): each stage's clamped cell
    coordinates, and gathers of whole fields at them."""

    def __init__(self, shape, ti, tj, tx, ty):
        self.shape, self.ti, self.tj, self.tx, self.ty = shape, ti, tj, tx, ty

    def cells(self, h):
        """Clamped rows and columns of the window `h` cells beyond the tile."""
        x, y = self.shape
        rows = torch.arange(self.ti - h, self.ti + self.tx + h).clamp(0, x - 1)
        cols = torch.arange(self.tj - h, self.tj + self.ty + h).clamp(0, y - 1)
        return rows, cols

    def gather(self, field, h):
        """`field` (..., X, Y) at the window's clamped cells."""
        rows, cols = self.cells(h)
        return field[..., rows, :][..., cols]

    def reclamp(self, win, h):
        """Each entry of a window computed position by position replaced by
        the entry at its clamped cell (the value computed there)."""
        rows, cols = self.cells(h)
        r = rows - (self.ti - h)
        c = cols - (self.tj - h)
        return win[..., r, :][..., c]


def _crop(win):
    return win[..., 1:-1, 1:-1]


def _short(win, short):
    """The window with its outermost `short` rings replaced by the nearest
    entry inside them: what a stage would read if its halo were `short`
    cells too narrow and its reads clamped at the window's edge."""
    if short == 0:
        return win
    h, w = win.shape[-2:]
    r = torch.arange(h).clamp(short, h - 1 - short)
    c = torch.arange(w).clamp(short, w - 1 - short)
    return win[..., r, :][..., c]


def _fused_tile(t, phase, f, f_alt, fx, fx_alt, fy, fy_alt, scene, re, dt, dx, p=None,
                vel=None, short=None):
    """One tile's six outputs (float32, tile-shaped) by the fused cascade.
    `short` names the stage whose window is one cell too narrow."""
    cut = {k: int(short == k) for k in HALO}
    nw = scene.not_wall
    # 1. BC: a pointwise rule on the pre-phase field, at the clamped cells.
    bc_full = velocity_bc(f32(f), scene) if phase == "velocity" else dye_bc(f32(f), scene)
    bc = _short(t.gather(bc_full, HALO["bc"]), cut["bc"])
    # 2. Non-advection on the BC window, kept on the tile + 2.
    if phase == "velocity":
        na = non_advection_velocity(bc, t.gather(f32(p), HALO["bc"]), re, dt, dx)
    else:
        na = non_advection_diffusion(bc, re, dt, dx)
    na = t.reclamp(_crop(na), HALO["na"])
    na = torch.where(t.gather(nw, HALO["na"]), na, t.gather(f32(f_alt), HALO["na"]))
    na = _short(na, cut["na"])
    # 3. Gradient update from Δ = f_na − f_bc on the tile + 2, kept on + 1.
    gx, gy = non_advection_grad(t.gather(f32(fx), HALO["na"]), t.gather(f32(fy), HALO["na"]),
                                _crop(bc), na, dx)
    nw1 = t.gather(nw, HALO["grad"])
    gx = torch.where(nw1, t.reclamp(_crop(gx), HALO["grad"]), t.gather(f32(fx_alt), HALO["grad"]))
    gy = torch.where(nw1, t.reclamp(_crop(gy), HALO["grad"]), t.gather(f32(fy_alt), HALO["grad"]))
    gx, gy = _short(gx, cut["grad"]), _short(gy, cut["grad"])
    # 4. Advection on the tile + 1, kept on the tile.
    na1 = _crop(na)
    u, w = (na1[0], na1[1]) if phase == "velocity" else t.gather(f32(vel), HALO["grad"])
    fn, fxn, fyn = (_crop(a) for a in cip_advect(na1, gx, gy, u, w, dt, dx))
    fluid = t.gather(scene.fluid, 0)
    cur = torch.where(fluid, fn, _crop(_crop(_crop(bc))))
    if phase == "dye":
        cur = clamp_field(cur, 0.0, 1.0)
    return (cur, torch.where(fluid, fxn, t.gather(f32(fx), 0)),
            torch.where(fluid, fyn, t.gather(f32(fy), 0)), _crop(na1), _crop(gx), _crop(gy))


def fused_phase(phase, args, tile, short=None):
    """The phase's six outputs assembled tile by tile, rounded once to the
    storage dtype as the kernel's stores round."""
    if phase == "velocity":
        v, p, v_alt, vx, vx_alt, vy, vy_alt, scene, re, dt, dx = args
        fields, extra = (v, v_alt, vx, vx_alt, vy, vy_alt), {"p": p}
    else:
        dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, vel, scene, re, dt, dx = args
        fields, extra = (dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt), {"vel": vel}
    x, y = scene.shape
    tx, ty = tile
    outs = [torch.empty_like(fields[0]) for _ in range(6)]
    for ti in range(0, x, tx):
        for tj in range(0, y, ty):
            got = _fused_tile(_Tile((x, y), ti, tj, tx, ty), phase, *fields, scene, re, dt, dx,
                              short=short, **extra)
            rows, cols = min(tx, x - ti), min(ty, y - tj)
            for o, g in zip(outs, got):
                o[:, ti:ti + rows, tj:tj + cols] = g[:, :rows, :cols].to(o.dtype)
    return tuple(outs)


PLAIN = {"velocity": cip_velocity_phase_plain, "dye": cip_dye_phase_plain}


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _equal(got, ref) -> bool:
    return all(g.dtype == r.dtype and torch.equal(_bits(g), _bits(r)) for g, r in zip(got, ref))


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("tile", TILES, ids=[f"{a}x{b}" for a, b in TILES])
@pytest.mark.parametrize("res", GRIDS.values(), ids=GRIDS.keys())
@pytest.mark.parametrize("bc_num", SCENES, ids=[f"scene{n}" for n in SCENES])
@pytest.mark.parametrize("phase", ["velocity", "dye"])
def test_fused_tiles_bit_equal_to_plain(phase, bc_num, res, tile, dtype):
    _, vel_args, dye_args = _inputs(bc_num, res, dtype)
    args = vel_args if phase == "velocity" else dye_args
    ref = PLAIN[phase](*args)
    got = fused_phase(phase, args, tile)
    assert _equal(got, ref), [int((_bits(g) != _bits(r)).sum()) for g, r in zip(got, ref)]


@pytest.mark.parametrize("stage", HALO.keys())
@pytest.mark.parametrize("phase", ["velocity", "dye"])
def test_halo_one_cell_short_differs(phase, stage):
    _, vel_args, dye_args = _inputs(2, 37, torch.float32)
    args = vel_args if phase == "velocity" else dye_args
    ref = PLAIN[phase](*args)
    assert _equal(fused_phase(phase, args, (8, 32)), ref)
    assert not _equal(fused_phase(phase, args, (8, 32), short=stage), ref)


def test_phase_bench_requires_a_card():
    """scripts/phase_bench.py refuses to measure without a card."""
    from fluid2d_tpu_torch.scripts import phase_bench

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            phase_bench.main(["--res", "8"])
        with pytest.raises(RuntimeError, match="no CUDA card"):
            phase_bench.main(["--res", "8", "--trees", "."])


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_phase_bench_calls_route_cpu_tensors_to_plain(dtype):
    """The script's calls on CPU tensors (A1's step pair, A2, A3, A4, B1):
    each wrapper takes its plain version, so kernel and plain outputs are
    the same to the bit; the shared-function calls (C1, B2, B3 upwind and
    KK) run at the same dtype and keep their input's shape and dtype; every
    timed call has a registered mix for its bound."""
    from fluid2d_tpu_torch.scripts import phase_bench
    from fluid2d_tpu_torch.utils import profiling

    calls = phase_bench.phase_calls(16, dtype, torch.device("cpu"))
    for name, (wrapper, plain, args) in calls.items():
        assert _equal(wrapper(*args), plain(*args)), name
    shared = phase_bench.shared_calls(16, torch.device("cpu"), dtype)
    for name, (fn, args) in shared.items():
        assert all(o.shape[-2:] == args[0].shape[-2:] and o.dtype == dtype
                   for o in fn(*args)), name
    assert set(phase_bench.BOUND_MIX) == set(calls) | set(shared)
    assert set(phase_bench.BOUND_MIX.values()) <= set(profiling._KERNEL_MIXES)
    bounds = phase_bench.bounds_ms(16)
    assert set(bounds["bound_ms"]) == set(bounds["ledger_bound_ms"])
    assert all(0 < b <= bounds["ledger_bound_ms"][k] for k, b in bounds["bound_ms"].items())
    assert bounds["bound_ms"]["confinement_float32"] < bounds["ledger_bound_ms"][
        "confinement_float32"]
