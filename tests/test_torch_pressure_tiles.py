"""The fused SOR (A1), confinement (A2) and Jacobi (B1) kernels' rules,
held on the CPU.

``csrc/sor.cu`` runs one or two red-black SOR iterations in one launch,
``csrc/jacobi.cu`` one to four Jacobi iterations and ``csrc/confinement.cu``
the confinement, each in one launch, a block a tile of output cells with
every stage's values in a window one cell wider on every side than the next
stage reads (SOR: the pressure on the tile + 3·n_iters, then the BC, the odd
and the even sweep a cell narrower each; Jacobi: the pressure on the tile
+ 2·n_iters, then the BC and the sweep a cell narrower each, the caller's
p_alt read at the first sweep's cells; confinement: the velocity on the
tile + 2, the curl on + 1). A window entry at a cell outside the grid holds
the stage's value at the clamped cell, computed there with that cell's
parity and codes. This file holds, with seeded NumPy inputs and no card:

(a) ``sor_iteration_plain(n_iters=2)``, with and without the limiter,
    against the JAX package's ``sor_iteration_pallas(n_iters=2)`` in
    interpret mode, at float32 and bf16;
(b) one two-iteration SOR call bit-equal to two chained one-iteration calls
    (float32 between them), on every pair link; a Jacobi call of n = 2..4
    iterations bit-equal to n chained calls of one, on every pair link;
(c) ``update_pressure_and_limit``, which pairs the iterations (1, 2 + 0,
    2 + 1, 2 + 2), bit-equal to the chain of one-iteration calls;
(d) the tiling rules, emulated here with the eager ops on window tensors
    tile by tile (not in the package: they check the designs before and
    beside the card), bit-equal to the plain versions on grids (74, 37) and
    (128, 64), for tiles of 4×8, 5×7 (odd origins), 8×32 and one larger
    than the grid, on scenes 2, 3 and 1 and an open scene (fluid to the
    grid's edge, which the scenes do not reach; for Jacobi also with every
    pressure BC code on the edge), Jacobi at n = 1..4 with and without the
    limiter and on every bf16 pair link. Negative controls, each of which
    must differ: a halo one cell short, the parity taken at the unclamped
    index, the curl computed as if outside the grid, and a Jacobi window
    (the BC's or the sweep's) one cell short.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid2d_tpu.ops.pallas_stencil import sor_iteration_pallas
from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
from fluid2d_tpu_torch import SimConfig, get_scene, scene_for_dtype
from fluid2d_tpu_torch.convert import scene_from_numpy
from fluid2d_tpu_torch.models.common import update_pressure_and_limit
from fluid2d_tpu_torch.ops.cuda_phases import confinement_plain
from fluid2d_tpu_torch.ops.cuda_stencil import (
    JACOBI_MAX_ITERS,
    SOR_MAX_ITERS,
    jacobi_iteration_plain,
    sor_iteration_plain,
)
from fluid2d_tpu_torch.ops.limiters import limit_vector_norm
from fluid2d_tpu_torch.ops.pressure import predict_p
from fluid2d_tpu_torch.ops.stencil import diff_x, diff_y, tmax, tmin
from fluid2d_tpu_torch.scenes.runtime_bc import pressure_bc

torch.set_num_threads(1)

OMEGA = 1.3
EPS = 5.0
LIMIT = 10.0
BF = torch.bfloat16
DTYPES = {"f32": torch.float32, "bf16": BF}


def _rnd(rng, lead, shape, scale):
    return (scale * rng.standard_normal((*lead, *shape))).astype(np.float32)


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF else torch.int32)


def _equal(got, ref) -> bool:
    return len(got) == len(ref) and all(
        g.dtype == r.dtype and g.shape == r.shape and torch.equal(_bits(g), _bits(r))
        for g, r in zip(got, ref))


# --- (a) the plain two-iteration call against the Pallas kernel -------------------

RES_A = 16  # scene 2 on a (32, 16) grid, tiles of 8 rows


@pytest.mark.parametrize("v_limit", [None, LIMIT], ids=["plain", "v_limit"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_sor_pair_plain_matches_pallas(dtype, v_limit):
    """Within 2e-5·max(1, |ref|max), at float32 and at bf16 (both round the
    float32 values once): the Pallas kernel's reciprocal-for-divide rewrites
    and FMA contraction, tests/test_pallas.py's contract."""
    jscene = jax_get_scene(2, RES_A)
    cfg = SimConfig.create(resolution=RES_A)
    rng = np.random.default_rng(7)
    shape = tuple(jscene.fluid8.shape)
    # u, w ~ N(0, 8²): many cells exceed the limit of 10, so the limiter bites.
    arrays = [_rnd(rng, (), shape, s) for s in (0.3, 0.3, 8.0, 8.0)]
    t = [torch.from_numpy(a).to(dtype) for a in arrays]
    j = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16 if dtype == BF else jnp.float32)
         for a in t]
    ref = sor_iteration_pallas(*j, jscene.pbc_code, jscene.fluid8, OMEGA, cfg.dt, cfg.dx,
                               n_iters=2, v_limit=v_limit, tile_x=8, interpret=True)
    sc = scene_from_numpy({k: np.asarray(v) for k, v in zip(jscene._fields, jscene)}, "cpu")
    got = sor_iteration_plain(*t, sc.pbc_code, sc.fluid8, OMEGA, cfg.dt, cfg.dx, n_iters=2,
                              v_limit=v_limit)
    assert len(got) == len(ref) == (2 if v_limit is None else 3)
    tol = 2e-5
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == dtype
        r = np.asarray(r.astype(jnp.float32))
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.float().numpy(), r, atol=tol * scale, rtol=0,
                                   err_msg=f"output {k}")


# --- (b), (c) the pair is the chain of single iterations --------------------------


def _pressure_inputs(dtype, res=24, bc=2):
    cfg = SimConfig.create(resolution=res, dtype=str(dtype).removeprefix("torch."))
    sc = scene_for_dtype(get_scene(bc, res, "cpu"), cfg)
    rng = np.random.default_rng(11 + bc)
    t = [torch.from_numpy(_rnd(rng, (), sc.shape, s)).to(dtype) for s in (0.3, 0.3, 8.0, 8.0)]
    return cfg, sc, t


# link → (pair read, pair returned): the velocity's dtype or float32
LINKS = {"state_state": (None, None), "state_f32": (None, torch.float32),
         "f32_state": (torch.float32, None), "f32_f32": (torch.float32, torch.float32)}


@pytest.mark.parametrize("v_limit", [None, LIMIT], ids=["plain", "v_limit"])
@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_two_iterations_equal_two_chained_calls(dtype, link, v_limit):
    cfg, sc, (p, pa, u, w) = _pressure_inputs(dtype)
    read, ret = LINKS[link]
    if read is not None:
        p, pa = p.to(read), pa.to(read)
    out = dtype if ret is None else ret
    args = (sc.pbc_code, sc.fluid8, OMEGA, cfg.dt, cfg.dx)
    got = sor_iteration_plain(p, pa, u, w, *args, n_iters=2, v_limit=v_limit, out_dtype=out)
    mid = sor_iteration_plain(p, pa, u, w, *args, out_dtype=torch.float32)
    ref = sor_iteration_plain(*mid, u, w, *args, v_limit=v_limit, out_dtype=out)
    assert _equal(got, ref)
    assert not _equal(got[:2], mid[:2])  # a second iteration moves the pair
    with pytest.raises(ValueError, match=f"1..{SOR_MAX_ITERS}"):
        sor_iteration_plain(p, pa, u, w, *args, n_iters=SOR_MAX_ITERS + 1)


@pytest.mark.parametrize("v_limit", [None, LIMIT], ids=["plain", "v_limit"])
@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_jacobi_call_equals_chained_calls_of_one(dtype, n, link, v_limit):
    """A call of n Jacobi iterations gives n chained calls of one (float32
    between them, the limiter on the last) to the bit."""
    cfg, sc, (p, pa, u, w) = _pressure_inputs(dtype)
    read, ret = LINKS[link]
    if read is not None:
        p, pa = p.to(read), pa.to(read)
    out = dtype if ret is None else ret
    args = (sc.pbc_code, sc.not_wall8, cfg.dt, cfg.dx)
    got = jacobi_iteration_plain(p, pa, u, w, *args, n_iters=n, v_limit=v_limit, out_dtype=out)
    pair = (p, pa)
    for _ in range(n - 1):
        pair = jacobi_iteration_plain(*pair, u, w, *args, out_dtype=torch.float32)
    ref = jacobi_iteration_plain(*pair, u, w, *args, v_limit=v_limit, out_dtype=out)
    assert _equal(got, ref)
    with pytest.raises(ValueError, match=f"1..{JACOBI_MAX_ITERS}"):
        jacobi_iteration_plain(p, pa, u, w, *args, n_iters=JACOBI_MAX_ITERS + 1)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_update_pressure_pairs_iterations_bit_equal_to_the_chain(dtype, n):
    """The greedy chain of calls of two (2 → one call, 3 → 2 + 1, 4 → 2 + 2)
    gives the chain of one-iteration calls to the bit."""
    cfg, sc, (p, pa, u, w) = _pressure_inputs(dtype)
    cfg = SimConfig.create(resolution=24, dtype=cfg.dtype, n_pressure_iter=n)
    got = update_pressure_and_limit(p, pa, torch.stack([u, w]), sc, cfg)
    pair = (p, pa)
    args = (sc.pbc_code, sc.fluid8, cfg.sor_omega, cfg.dt, cfg.dx)
    for _ in range(n - 1):
        pair = sor_iteration_plain(*pair, u, w, *args, out_dtype=torch.float32)
    ref = sor_iteration_plain(*pair, u, w, *args, v_limit=cfg.velocity_limit, out_dtype=dtype)
    assert _equal(got, ref)


# --- (d) the tiling rule -------------------------------------------------------------

GRIDS = {"74x37": 37, "128x64": 64}  # resolution → a (2·res, res) grid
TILES = [(4, 8), (5, 7), (8, 32), (256, 128)]  # the last is larger than either grid
SCENES = {"scene2": 2, "scene3": 3, "scene1": 1, "open": None}


class _Open:
    """A scene with fluid to the grid's edge and no pressure BC: the stage
    values at the edge rows and columns, which the scenes' walls never
    reach, decide the tiles' outputs there."""

    def __init__(self, shape):
        self.shape = shape
        self.pbc_code = torch.zeros(shape, dtype=torch.int8)
        self.fluid8 = self.not_wall8 = torch.ones(shape, dtype=torch.int8)


class _OpenCodes(_Open):
    """The open scene with the pressure BC codes 1..10 in turn along its
    first and last rows and columns: the BC'd values at the clamped cells
    decide the edge cells' sweeps."""

    def __init__(self, shape):
        super().__init__(shape)
        x, y = shape
        cyc = (torch.arange(2 * (x + y)) % 10 + 1).to(torch.int8)
        self.pbc_code[0], self.pbc_code[-1] = cyc[:y], cyc[1:y + 1]
        self.pbc_code[:, 0], self.pbc_code[:, -1] = cyc[2:x + 2], cyc[3:x + 3]


def _scene(bc, res):
    if bc in (None, "codes"):
        return (_Open if bc is None else _OpenCodes)((2 * res, res))
    return get_scene(bc, res, "cpu")


class _Tile:
    """Window geometry of the tile at (ti, tj): the clamped rows and columns
    of the window `h` cells beyond it, and gathers at them."""

    def __init__(self, shape, ti, tj, tx, ty):
        self.shape, self.ti, self.tj, self.tx, self.ty = shape, ti, tj, tx, ty

    def positions(self, h):
        """Rows and columns of the window `h` cells beyond the tile."""
        return (torch.arange(self.ti - h, self.ti + self.tx + h),
                torch.arange(self.tj - h, self.tj + self.ty + h))

    def cells(self, h):
        rows, cols = self.positions(h)
        return rows.clamp(0, self.shape[0] - 1), cols.clamp(0, self.shape[1] - 1)

    def gather(self, field, h):
        rows, cols = self.cells(h)
        return field[..., rows, :][..., cols]

    def reclamp(self, win, h):
        """Each entry of a window computed position by position replaced by
        the entry at its clamped cell: the value computed there."""
        rows, cols = self.cells(h)
        return win[..., rows - (self.ti - h), :][..., cols - (self.tj - h)]

    def parity(self, h, clamped=True):
        """(i + j) % 2 == 1 at the window's cells, or (the negative control)
        at its positions."""
        rows, cols = self.cells(h) if clamped else self.positions(h)
        return (rows[:, None] + cols[None, :]) % 2 == 1


def _crop(win, n=1):
    return win[..., n:-n, n:-n] if n else win


def _short(win):
    """The window with its outermost ring replaced by the nearest entry
    inside it: what a stage reads if that window is one cell too narrow."""
    h, w = win.shape[-2:]
    r = torch.arange(h).clamp(1, h - 2)
    c = torch.arange(w).clamp(1, w - 2)
    return win[..., r, :][..., c]


class _Codes:
    def __init__(self, pbc_code):
        self.pbc_code = pbc_code


def _sor_tile(t, n_iters, p, pa, u, w, scene, dt, dx, v_limit, short=None, unclamped=False):
    """One tile's outputs (float32, tile-shaped) by the fused cascade: the
    pressure on the tile + 3·n_iters, each stage on a window one cell
    narrower, evaluated at the clamped cells. `short` = (stage, iteration)
    names a window one cell too narrow; `unclamped` takes the parity at the
    window positions."""
    hh = 3 * n_iters
    fluid = scene.fluid8 != 0
    cur = t.gather(p, hh)
    alt = t.gather(pa, hh - 2)
    for it in range(n_iters):
        h = hh - 3 * it
        uw, ww = t.gather(u, h - 1), t.gather(w, h - 1)
        # 1. BC on the tile + (h − 1)
        bc = t.reclamp(_crop(pressure_bc(cur, _Codes(t.gather(scene.pbc_code, h)))), h - 1)
        if short == ("bc", it):
            bc = _short(bc)
        # 2. odd sweep on + (h − 2), onto the alt values
        cand = (1.0 - OMEGA) * bc + OMEGA * predict_p(bc, uw, ww, dt, dx)
        odd = t.gather(fluid, h - 2) & t.parity(h - 2, clamped=not unclamped)
        pn = torch.where(odd, t.reclamp(_crop(cand), h - 2), alt)
        if short == ("odd", it):
            pn = _short(pn)
        # 3. even sweep on + (h − 3)
        cand = (1.0 - OMEGA) * pn + OMEGA * predict_p(pn, _crop(uw), _crop(ww), dt, dx)
        even = t.gather(fluid, h - 3) & ~t.parity(h - 3, clamped=not unclamped)
        cur = torch.where(even, t.reclamp(_crop(cand), h - 3), _crop(pn))
        alt = _crop(bc, 4)  # the BC'd input is the next iteration's alt base (+ h − 5)
    out = (cur, _crop(bc, 2))
    if v_limit is not None:
        out += (limit_vector_norm(torch.stack([t.gather(u, 0), t.gather(w, 0)]), v_limit),)
    return out


def _confinement_tile(t, v, v_alt, scene, dt, dx, as_if_outside=False):
    """One tile's updated velocity by the fused kernel: u, w on the tile
    + 2, the curl on + 1 at the clamped cells (or, the negative control,
    at the window positions), the force on the tile."""
    fluid = t.gather(scene.fluid8 != 0, 1)
    vw = t.gather(v, 2)
    curl = _crop(diff_x(vw[1], dx) - diff_y(vw[0], dx))
    if not as_if_outside:
        curl = t.reclamp(curl, 1)
    vorticity = torch.where(fluid, curl, 0.0)
    vort_abs = torch.where(fluid, torch.abs(curl), 0.0)
    gx, gy = _crop(diff_x(vort_abs, dx)), _crop(diff_y(vort_abs, dx))
    norm = torch.sqrt(gx * gx + gy * gy)
    nx, ny = gx / norm, gy / norm
    om = _crop(vorticity)
    force = torch.stack([tmax(tmin(ny * om, 0.1), -0.1), tmax(tmin(-nx * om, 0.1), -0.1)])
    return (torch.where(_crop(fluid), _crop(vw, 2) + dt * EPS * force, t.gather(v_alt, 0)),)


def _assemble(shape, tile, dtypes, tile_fn):
    """Outputs of every tile, assembled and rounded once to their dtypes."""
    x, y = shape
    tx, ty = tile
    outs = None
    for ti in range(0, x, tx):
        for tj in range(0, y, ty):
            got = tile_fn(_Tile(shape, ti, tj, tx, ty))
            if outs is None:
                outs = [torch.empty((*g.shape[:-2], x, y), dtype=d) for g, d in zip(got, dtypes)]
            rows, cols = min(tx, x - ti), min(ty, y - tj)
            for o, g in zip(outs, got):
                o[..., ti:ti + rows, tj:tj + cols] = g[..., :rows, :cols].to(o.dtype)
    return tuple(outs)


def _tile_inputs(bc, res, dtype):
    scene = _scene(bc, res)
    cfg = SimConfig.create(resolution=res)
    rng = np.random.default_rng(100 * (bc if isinstance(bc, int) else 0) + res)
    shape = scene.shape
    p, pa, u, w = (torch.from_numpy(_rnd(rng, (), shape, s)).to(dtype)
                   for s in (0.3, 0.3, 8.0, 8.0))
    v, va = (torch.from_numpy(_rnd(rng, (2,), shape, s)).to(dtype) for s in (3.0, 0.5))
    return scene, cfg, (p, pa, u, w), (v, va)


def fused_sor(scene, cfg, inputs, n_iters, v_limit, tile, **control):
    p, pa, u, w = inputs
    f = [a.float() for a in inputs]
    dts = [p.dtype] * 2 + ([u.dtype] if v_limit is not None else [])
    return _assemble(scene.shape, tile, dts, lambda t: _sor_tile(
        t, n_iters, *f, scene, cfg.dt, cfg.dx, v_limit, **control))


def plain_sor(scene, cfg, inputs, n_iters, v_limit):
    return sor_iteration_plain(*inputs, scene.pbc_code, scene.fluid8, OMEGA, cfg.dt, cfg.dx,
                               n_iters=n_iters, v_limit=v_limit)


def fused_confinement(scene, cfg, vel, tile, **control):
    v, va = vel
    return _assemble(scene.shape, tile, [v.dtype], lambda t: _confinement_tile(
        t, v.float(), va.float(), scene, cfg.dt, cfg.dx, **control))


def plain_confinement(scene, cfg, vel):
    return confinement_plain(*vel, scene.fluid8, cfg.dt, EPS, cfg.dx)[:1]


KERNELS = {"sor1": (1, None), "sor2": (2, None), "sor2_v_limit": (2, LIMIT),
           "confinement": (None, None)}


@pytest.mark.parametrize("tile", TILES, ids=[f"{a}x{b}" for a, b in TILES])
@pytest.mark.parametrize("res", GRIDS.values(), ids=GRIDS.keys())
@pytest.mark.parametrize("bc", SCENES.values(), ids=SCENES.keys())
@pytest.mark.parametrize("kernel", KERNELS)
def test_fused_tiles_bit_equal_to_plain(kernel, bc, res, tile):
    scene, cfg, pressure, vel = _tile_inputs(bc, res, torch.float32)
    n_iters, v_limit = KERNELS[kernel]
    if n_iters is None:
        got, ref = fused_confinement(scene, cfg, vel, tile), plain_confinement(scene, cfg, vel)
    else:
        got = fused_sor(scene, cfg, pressure, n_iters, v_limit, tile)
        ref = plain_sor(scene, cfg, pressure, n_iters, v_limit)
    assert _equal(got, ref), [int((_bits(g) != _bits(r)).sum()) for g, r in zip(got, ref)]


@pytest.mark.parametrize("kernel", KERNELS)
def test_fused_tiles_bit_equal_to_plain_bf16(kernel):
    """At bf16 the windows hold the widened values and each output is
    rounded once, at its store."""
    scene, cfg, pressure, vel = _tile_inputs(3, 37, BF)
    n_iters, v_limit = KERNELS[kernel]
    if n_iters is None:
        got, ref = fused_confinement(scene, cfg, vel, (5, 7)), plain_confinement(scene, cfg, vel)
    else:
        got = fused_sor(scene, cfg, pressure, n_iters, v_limit, (5, 7))
        ref = plain_sor(scene, cfg, pressure, n_iters, v_limit)
    assert got[0].dtype == BF and _equal(got, ref)


# negative controls: (kernel, scene, control). The parity and the curl at the
# grid's edge decide the outputs only where fluid reaches the edge: the open
# scene (the scenes' walls keep the edge cells out of the sweeps and the curl).
CONTROLS = {
    "sor1_odd_short_scene2": ("sor1", 2, {"short": ("odd", 0)}),
    "sor2_odd_short_scene2": ("sor2", 2, {"short": ("odd", 1)}),
    "sor2_bc_short_scene2": ("sor2", 2, {"short": ("bc", 1)}),
    "sor2_bc_short_open": ("sor2", None, {"short": ("bc", 1)}),
    "sor1_parity_unclamped_open": ("sor1", None, {"unclamped": True}),
    "sor2_parity_unclamped_open": ("sor2", None, {"unclamped": True}),
    "confinement_curl_as_if_outside_open": ("confinement", None, {"as_if_outside": True}),
}


@pytest.mark.parametrize("control", CONTROLS)
def test_negative_control_differs(control):
    kernel, bc, kw = CONTROLS[control]
    scene, cfg, pressure, vel = _tile_inputs(bc, 37, torch.float32)
    n_iters, v_limit = KERNELS[kernel]
    if n_iters is None:
        ref = plain_confinement(scene, cfg, vel)
        assert _equal(fused_confinement(scene, cfg, vel, (8, 32)), ref)
        assert not _equal(fused_confinement(scene, cfg, vel, (8, 32), **kw), ref)
    else:
        ref = plain_sor(scene, cfg, pressure, n_iters, v_limit)
        assert _equal(fused_sor(scene, cfg, pressure, n_iters, v_limit, (8, 32)), ref)
        assert not _equal(fused_sor(scene, cfg, pressure, n_iters, v_limit, (8, 32), **kw), ref)


# --- the fused Jacobi iteration (B1) ---------------------------------------------


def _jacobi_tile(t, n_iters, p, pa, u, w, scene, dt, dx, v_limit, short=None):
    """One tile's outputs (float32, tile-shaped) by the fused cascade: the
    pressure on the tile + 2·n_iters, the BC and the sweep each on a window
    one cell narrower, evaluated at the clamped cells; the caller's p_alt at
    the first sweep's cells, the previous BC after it. `short` = (stage,
    iteration) names a window one cell too narrow."""
    hh = 2 * n_iters
    not_wall = scene.not_wall8 != 0
    cur = t.gather(p, hh)
    alt = t.gather(pa, hh - 2)
    for it in range(n_iters):
        h = hh - 2 * it
        uw, ww = t.gather(u, h - 1), t.gather(w, h - 1)
        # 1. BC on the tile + (h − 1)
        bc = t.reclamp(_crop(pressure_bc(cur, _Codes(t.gather(scene.pbc_code, h)))), h - 1)
        if short == ("bc", it):
            bc = _short(bc)
        # 2. the sweep on + (h − 2): the prediction at not-wall cells, alt elsewhere
        cur = torch.where(t.gather(not_wall, h - 2),
                          t.reclamp(_crop(predict_p(bc, uw, ww, dt, dx)), h - 2), alt)
        if short == ("sweep", it):
            cur = _short(cur)
        alt = _crop(bc, 3)  # the next iteration's alt, on its sweep's + (h − 4)
    out = (cur, _crop(bc))
    if v_limit is not None:
        out += (limit_vector_norm(torch.stack([t.gather(u, 0), t.gather(w, 0)]), v_limit),)
    return out


def fused_jacobi(scene, cfg, inputs, n_iters, v_limit, tile, out_dtype=None, **control):
    p, pa, u, w = inputs
    f = [a.float() for a in inputs]
    dts = [out_dtype or p.dtype] * 2 + ([u.dtype] if v_limit is not None else [])
    return _assemble(scene.shape, tile, dts, lambda t: _jacobi_tile(
        t, n_iters, *f, scene, cfg.dt, cfg.dx, v_limit, **control))


def plain_jacobi(scene, cfg, inputs, n_iters, v_limit, out_dtype=None):
    return jacobi_iteration_plain(*inputs, scene.pbc_code, scene.not_wall8, cfg.dt, cfg.dx,
                                  n_iters=n_iters, v_limit=v_limit, out_dtype=out_dtype)


JACOBI_SCENES = {**SCENES, "open_codes": "codes"}
JACOBI_TILES = [(4, 8), (5, 7), (256, 128)]


@pytest.mark.parametrize("v_limit", [None, LIMIT], ids=["plain", "v_limit"])
@pytest.mark.parametrize("n_iters", [1, 2, 3, 4])
@pytest.mark.parametrize("tile", JACOBI_TILES, ids=[f"{a}x{b}" for a, b in JACOBI_TILES])
@pytest.mark.parametrize("bc", JACOBI_SCENES.values(), ids=JACOBI_SCENES.keys())
def test_fused_jacobi_tiles_bit_equal_to_plain(bc, tile, n_iters, v_limit):
    scene, cfg, pressure, _ = _tile_inputs(bc, 37, torch.float32)
    got = fused_jacobi(scene, cfg, pressure, n_iters, v_limit, tile)
    ref = plain_jacobi(scene, cfg, pressure, n_iters, v_limit)
    assert _equal(got, ref), [int((_bits(g) != _bits(r)).sum()) for g, r in zip(got, ref)]


@pytest.mark.parametrize("n_iters", [1, 4])
@pytest.mark.parametrize("bc", [2, "codes"], ids=["scene2", "open_codes"])
def test_fused_jacobi_tiles_bit_equal_to_plain_128x64(bc, n_iters):
    """The larger grid, whole 8×32 tiles."""
    scene, cfg, pressure, _ = _tile_inputs(bc, 64, torch.float32)
    got = fused_jacobi(scene, cfg, pressure, n_iters, LIMIT, (8, 32))
    assert _equal(got, plain_jacobi(scene, cfg, pressure, n_iters, LIMIT))


@pytest.mark.parametrize("v_limit", [None, LIMIT], ids=["plain", "v_limit"])
@pytest.mark.parametrize("n_iters", [1, 2, 3, 4])
@pytest.mark.parametrize("link", LINKS)
def test_fused_jacobi_tiles_bit_equal_to_plain_bf16(link, n_iters, v_limit):
    """At bf16 state every pair link: the windows hold the widened values,
    the chain stays float32 inside a call and each output is rounded once,
    at its store."""
    scene, cfg, (p, pa, u, w), _ = _tile_inputs(3, 37, BF)
    read, ret = LINKS[link]
    if read is not None:
        p, pa = p.to(read), pa.to(read)
    out = BF if ret is None else ret
    got = fused_jacobi(scene, cfg, (p, pa, u, w), n_iters, v_limit, (5, 7), out_dtype=out)
    ref = plain_jacobi(scene, cfg, (p, pa, u, w), n_iters, v_limit, out_dtype=out)
    assert got[0].dtype == out and _equal(got, ref)


# negative controls: (scene, n_iters, short). The pressure BC reads a
# neighbour only at coded cells, so a window short by one cell reaches a
# tile's outputs through an earlier iteration only where codes meet a tile's
# edge: along the grid's edge in the open scene with codes.
JACOBI_CONTROLS = {
    "bc_short_last_scene2": (2, 2, ("bc", 1)),
    "bc_short_first_open_codes": ("codes", 3, ("bc", 0)),
    "sweep_short_open_codes": ("codes", 2, ("sweep", 0)),
    "sweep_short_n4_open_codes": ("codes", 4, ("sweep", 2)),
    "bc_short_n1_open_codes": ("codes", 1, ("bc", 0)),
}


@pytest.mark.parametrize("control", JACOBI_CONTROLS)
def test_jacobi_negative_control_differs(control):
    bc, n_iters, short = JACOBI_CONTROLS[control]
    scene, cfg, pressure, _ = _tile_inputs(bc, 37, torch.float32)
    ref = plain_jacobi(scene, cfg, pressure, n_iters, None)
    assert _equal(fused_jacobi(scene, cfg, pressure, n_iters, None, (8, 32)), ref)
    assert not _equal(fused_jacobi(scene, cfg, pressure, n_iters, None, (8, 32), short=short),
                      ref)
