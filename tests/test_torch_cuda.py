"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one.

This file imports no JAX, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: a kernel's outputs within 1e-5·max(1, |ref|max) of the plain
version (the same f32 algebra; nvcc may contract a*b+c into an FMA); a
multi-step run within 2e-5·max(1, |ref|max) on every state leaf. The
roofline's probes: the copy (C2) bit-equal, the mix twin (C3) and the FMA
chains (C4, at a shallow 64 passes) within 1e-5·max(1, |ref|max); C4 at
its full 8192 passes within cuda_probes.fma_rate_error_bound of the
float64 plain version.

At bf16 transport every kernel variant and pressure chain link is held to
its plain version bit for bit (NaN equal to NaN: the card's canonical bf16
NaN is not the one PyTorch's conversion gives): the kernels round each
float32 value once, where the plain versions do, and the float32 values
are the plain versions' to the bit. The bf16 probes: the dtype-rate chains
(C5a) within ``RATE_TOL_ULPS`` of their plain version, which a step more or
fewer misses; the row copies (C5b) and the bf16 twin (C5c) bit-equal.

The fused CIP phases (one launch a phase on tiles with a recomputed halo)
bit-equal at float32 and bf16 on grids smaller than a tile, ragged grids,
scene 3's outflow and scene 1's walls, with one launch and six output
allocations (no scratch); C1 and the MAC phases, which share their per-cell
functions, bit-equal on those scenes too. The fused SOR (one and two
iterations, with and without the limiter, on every pair link) and the fused
confinement bit-equal at float32 and bf16 on the same grids and on an open
scene (fluid to the grid's edge), with one launch and only the outputs
allocated. The fused Jacobi iteration (B1, one launch a call of 1..4
iterations, with and without the limiter, on every pair link) bit-equal on
the same grids and an open scene with every pressure BC code on its edge,
with one launch and only the outputs allocated. The fused MAC dye phase
(B3, one launch on tiles with a recomputed halo of 1 or 2) bit-equal for
both schemes at float32 and bf16 on the same grids, an open scene with
inflow to its edge and 3200×1600, with one launch and two output
allocations (no scratch); its one entry point refuses what the two
per-dtype ones refused. The fused MAC velocity phase (B2, one launch: the
pre-BC velocity on the tile + 3 or + 4, the BC'd on + 1 or + 2) the same,
on an open scene with every velocity BC code on its edge.

The benchmark's kk800 settings (scene 2 at 1600×800, KK, dt 0.0125/800,
confinement, dye): one ``step(100)`` through the kernels bit-equal to the
eager path. KK's MAC phases open their ``.kk`` spans and move their
``.kk`` launch-counter keys. The benchmark's cip1600_jacobi6 settings
(the headline with Jacobi ×6): one ``step(100)`` on the graph path
bit-equal to the eager path, two Jacobi launches a step under
``f2d_jacobi_iteration.n4`` and ``.n2``.

The graph path of ``FluidSimulator.step`` (``models/replay.py``): n = 1, 2,
5 and 100 replayed steps, and n more from the layout reached, bit-equal to
``make_run_fn``'s eager loop on every leaf, alternates included, for CIP,
upwind, KK, CIP at bf16, KK with six Jacobi iterations at bf16 and upwind
with three SOR iterations and no confinement, the workspace filled with NaN
before the capture; 7 + 5 steps equal to 12; one state copy after
``reset`` and after an assigned state, none for a simulator made by
``load``; the launch counter moving by the eager loop's counts a step; no
eager step, state copy or capture over the view's frames after their
warm-up; and the eager loop where the path does not engage
(``kernels="eager"``, no pressure solve).

The standalone CIP advection (C1, one launch on 32×32 tiles of every
channel) bit-equal at float32 and bf16 in both forms, on scene 2 and on
open scenes with fluid to every edge, into fresh outputs and `out=`; the
dtype-rate chains (C5a) also on inputs that leave a ragged tail of each
thread's group of chains, aligned and at a 4-byte offset; the FMA
sweep (C5d) within ``fma_rate_error_bound`` of the float64 plain version,
which one round short exceeds; the geometry twin (C5e/f) within
1e-5·max(1, |ref|max); the row window (C5g, with 1, 2 and 8 tiles a
persistent block) and the el-op toys (C6, with ragged tails and a
misaligned view) bit-equal; the row copies (C5b) bit-equal at several t,
the tail copy spread over one block a row.

The view's 8-bit image (V1, one launch a ``to_image`` of a CUDA frame)
bit-equal to the NumPy path of ``utils/viz.py:to_image`` on the four views
of a stepped state at 3200×1600 and 800×400, on random frames with NaN and
±inf at those grids and at ragged shapes, on the edge values of
``tests/test_torch_view.py`` and on a frame that is not 16-byte aligned;
each returned array the caller's, left as it was by later calls.
"""

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch import SimConfig, get_scene, init_state, make_run_fn, scene_for_dtype
from fluid2d_tpu_torch.ops import cuda_dtype_probes, cuda_phases, cuda_probes, cuda_stencil
from fluid2d_tpu_torch.utils import profiling, trace
from fluid2d_tpu_torch.utils.trace import launches

torch.set_num_threads(1)

RES = 64  # scene 2 on a (128, 64) grid: whole 32×32 tiles
RAGGED_RES = 37  # (74, 37): neither axis a multiple of the block


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _runs(wrapper) -> int:
    """Kernel runs so far of the C entry points `wrapper` launches (the
    launch counter, ``utils/trace.py``): ``f2d_<name>`` and its forms
    counted apart (``f2d_<name>.kk``), and its ``_bf16`` twin for the
    wrappers that take one entry point per storage type."""
    base = "f2d_" + wrapper.__name__.removesuffix("_cuda")
    twins = (cuda_dtype_probes.dtype_rate_cuda, cuda_dtype_probes.row_copy_cuda)
    runs = trace.entry_launches()
    return runs[base] + (runs[base + "_bf16"] if wrapper in twins else 0)


def _assert_close(got, ref, what, tol):
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype, f"{what}[{k}]"
        scale = max(1.0, float(r.abs().max()))
        err = float((g - r).abs().max())
        assert err <= tol * scale, f"{what}[{k}]: max error {err} > {tol} * {scale}"


def _kernel_calls(res: int, device):
    """(wrapper, plain version, args, kwargs) per kernel on seeded inputs."""
    cfg = SimConfig.create(resolution=res, re=1000.0)
    sc = get_scene(2, res, device)
    shape = sc.shape
    gen = torch.Generator(device="cpu").manual_seed(res)

    def rnd(lead, scale):
        return (scale * torch.randn((*lead, *shape), generator=gen)).to(device)

    p, pa = rnd((), 0.3), rnd((), 0.3)
    u, w = rnd((), 8.0), rnd((), 8.0)
    v, va = rnd((2,), 0.5), rnd((2,), 0.5)
    vg = [rnd((2,), 0.1) for _ in range(4)]
    dye = rnd((3,), 0.5) + 0.5
    dg = [rnd((3,), 0.1) for _ in range(5)]
    sor = (p, pa, u, w, sc.pbc_code, sc.fluid8, cfg.sor_omega, cfg.dt, cfg.dx)
    jacobi = (p, pa, u, w, sc.pbc_code, sc.not_wall8, cfg.dt, cfg.dx)
    return [
        (cuda_stencil.sor_iteration_cuda, cuda_stencil.sor_iteration_plain, sor, {}),
        (cuda_stencil.sor_iteration_cuda, cuda_stencil.sor_iteration_plain, sor,
         {"v_limit": cfg.velocity_limit}),
        (cuda_phases.confinement_cuda, cuda_phases.confinement_plain,
         (v, va, sc.fluid8, cfg.dt, 5.0, cfg.dx), {}),
        (cuda_phases.cip_velocity_phase_cuda, cuda_phases.cip_velocity_phase_plain,
         (v, p, va, vg[0], vg[1], vg[2], vg[3], sc, cfg.re, cfg.dt, cfg.dx), {}),
        (cuda_phases.cip_dye_phase_cuda, cuda_phases.cip_dye_phase_plain,
         (dye, *dg, v, sc, cfg.re, cfg.dt, cfg.dx), {}),
        *((cuda_stencil.jacobi_iteration_cuda, cuda_stencil.jacobi_iteration_plain, jacobi,
           {"n_iters": n, "v_limit": lim}) for n, lim in ((1, None), (2, cfg.velocity_limit),
                                                        (4, None), (4, cfg.velocity_limit))),
        *((cuda_phases.mac_velocity_phase_cuda, cuda_phases.mac_velocity_phase_plain,
           (v, p, va, sc, scheme, cfg.re, cfg.dt, cfg.dx), {}) for scheme in ("upwind", "kk")),
        *((cuda_phases.mac_dye_phase_cuda, cuda_phases.mac_dye_phase_plain,
           (dye, dg[0], v, sc, scheme, cfg.dt, cfg.dx), {}) for scheme in ("upwind", "kk")),
        *((cuda_stencil.sor_iteration_cuda, cuda_stencil.sor_iteration_plain, sor,
           {"n_iters": 2, "v_limit": lim}) for lim in (None, cfg.velocity_limit)),
    ]


KERNEL_IDS = ["sor", "sor_v_limit", "confinement", "cip_velocity", "cip_dye",
              "jacobi1", "jacobi2_v_limit", "jacobi4", "jacobi4_v_limit",
              "mac_velocity_upwind", "mac_velocity_kk", "mac_dye_upwind", "mac_dye_kk",
              "sor2", "sor2_v_limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("res", [RES, RAGGED_RES])
@pytest.mark.parametrize("which", range(len(KERNEL_IDS)), ids=KERNEL_IDS)
def test_cuda_kernel_matches_plain(cuda_device, which, res):
    wrapper, plain, args, kwargs = _kernel_calls(res, cuda_device)[which]
    before = _runs(wrapper)
    got = wrapper(*args, **kwargs)
    torch.cuda.synchronize()
    assert _runs(wrapper) == before + 1
    _assert_close(got, plain(*args, **kwargs), wrapper.__name__, 1e-5)


def _bf16_calls(res: int, device):
    """(name, wrapper, plain version, args, kwargs) per kernel variant and
    pressure chain link, on bf16 state and scene."""
    cfg = SimConfig.create(resolution=res, re=1000.0, dtype="bfloat16")
    sc = scene_for_dtype(get_scene(2, res, device), cfg)
    gen = torch.Generator(device="cpu").manual_seed(res + 1)

    def rnd(lead, scale, offset=0.0):
        t = offset + scale * torch.randn((*lead, *sc.shape), generator=gen)
        return t.to(torch.bfloat16).to(device)

    p, pa = rnd((), 0.3), rnd((), 0.3)
    u, w = rnd((), 8.0), rnd((), 8.0)
    v, va = rnd((2,), 0.5), rnd((2,), 0.5)
    vg = [rnd((2,), 0.1) for _ in range(4)]
    dye = rnd((3,), 0.5, 0.5)
    dg = [rnd((3,), 0.1) for _ in range(5)]
    lim = cfg.velocity_limit
    calls = [
        ("confinement", cuda_phases.confinement_cuda, cuda_phases.confinement_plain,
         (v, va, sc.fluid8, cfg.dt, 5.0, cfg.dx), {}),
        ("cip_velocity", cuda_phases.cip_velocity_phase_cuda, cuda_phases.cip_velocity_phase_plain,
         (v, p, va, *vg, sc, cfg.re, cfg.dt, cfg.dx), {}),
        ("cip_dye", cuda_phases.cip_dye_phase_cuda, cuda_phases.cip_dye_phase_plain,
         (dye, *dg, v, sc, cfg.re, cfg.dt, cfg.dx), {}),
    ]
    for scheme in ("upwind", "kk"):
        calls.append((f"mac_velocity_{scheme}", cuda_phases.mac_velocity_phase_cuda,
                      cuda_phases.mac_velocity_phase_plain,
                      (v, p, va, sc, scheme, cfg.re, cfg.dt, cfg.dx), {}))
        calls.append((f"mac_dye_{scheme}", cuda_phases.mac_dye_phase_cuda,
                      cuda_phases.mac_dye_phase_plain, (dye, dg[0], v, sc, scheme, cfg.dt, cfg.dx),
                      {}))
    # the chain links: bf16 → f32, f32 → f32, f32 → bf16, bf16 → bf16
    links = {"bf16_f32": (p, pa, torch.float32), "f32_f32": (p.float(), pa.float(), torch.float32),
             "f32_bf16": (p.float(), pa.float(), torch.bfloat16),
             "bf16_bf16": (p, pa, torch.bfloat16)}
    for link, (pc, pal, out) in links.items():
        for vl in (None, lim):
            sfx = link + ("_v_limit" if vl else "")
            calls.append((f"sor_{sfx}", cuda_stencil.sor_iteration_cuda,
                          cuda_stencil.sor_iteration_plain,
                          (pc, pal, u, w, sc.pbc_code, sc.fluid8, cfg.sor_omega, cfg.dt, cfg.dx),
                          {"v_limit": vl, "out_dtype": out}))
            calls.append((f"sor2_{sfx}", cuda_stencil.sor_iteration_cuda,
                          cuda_stencil.sor_iteration_plain,
                          (pc, pal, u, w, sc.pbc_code, sc.fluid8, cfg.sor_omega, cfg.dt, cfg.dx),
                          {"n_iters": 2, "v_limit": vl, "out_dtype": out}))
            for n in range(1, 5):
                calls.append((f"jacobi{n}_{sfx}", cuda_stencil.jacobi_iteration_cuda,
                              cuda_stencil.jacobi_iteration_plain,
                              (pc, pal, u, w, sc.pbc_code, sc.not_wall8, cfg.dt, cfg.dx),
                              {"n_iters": n, "v_limit": vl, "out_dtype": out}))
    return calls


BF16_IDS = ["confinement", "cip_velocity", "cip_dye",
            *(f"mac_{phase}_{scheme}" for scheme in ("upwind", "kk")
              for phase in ("velocity", "dye")),
            *(f"{kernel}_{link}{sfx}" for link in ("bf16_f32", "f32_f32", "f32_bf16", "bf16_bf16")
              for sfx in ("", "_v_limit")
              for kernel in ("sor", "sor2", *(f"jacobi{n}" for n in range(1, 5))))]


def _assert_bit_equal(got, ref, what):
    """Equal to the bit, dtypes included, a NaN equal to any NaN."""
    assert len(got) == len(ref), what
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype, f"{what}[{k}]"
        gf, rf = g.float(), r.float()
        nan = torch.isnan(gf)
        assert torch.equal(nan, torch.isnan(rf)), f"{what}[{k}]: NaN at other cells"
        bad = (gf != rf) & ~nan
        assert not bool(bad.any()), f"{what}[{k}]: {int(bad.sum())} cells differ"


@pytest.mark.cuda
@pytest.mark.parametrize("res", [RES, RAGGED_RES])
@pytest.mark.parametrize("which", range(len(BF16_IDS)), ids=BF16_IDS)
def test_cuda_bf16_kernel_bit_equal_to_plain(cuda_device, which, res):
    name, wrapper, plain, args, kwargs = _bf16_calls(res, cuda_device)[which]
    assert name == BF16_IDS[which]
    before = _runs(wrapper)
    got = wrapper(*args, **kwargs)
    torch.cuda.synchronize()
    assert _runs(wrapper) == before + 1
    _assert_bit_equal(got, plain(*args, **kwargs), BF16_IDS[which])


@pytest.mark.cuda
@pytest.mark.parametrize("config", [{}, {"scheme": "upwind"}, {"scheme": "kk"},
                                    {"pressure_solver": "jacobi", "n_pressure_iter": 6},
                                    {"n_pressure_iter": 3}],
                         ids=["cip", "upwind", "kk", "cip_jacobi6", "cip_sor3"])
def test_cuda_bf16_run_bit_equal_to_eager_run(cuda_device, config):
    """4 bf16 steps through the kernels and through the plain versions, from
    a seeded state: every leaf bit-equal."""
    outs = {}
    for mode in ("cuda", "eager"):
        cfg = SimConfig.create(resolution=RES, kernels=mode, dtype="bfloat16", **config)
        sc = scene_for_dtype(get_scene(2, RES, cuda_device), cfg)
        gen = torch.Generator(device="cpu").manual_seed(9)
        st = init_state(sc, cfg, cuda_device)
        fluid = (sc.mask == 0).float()
        st = st._replace(v=(0.3 * torch.randn((2, *sc.shape), generator=gen).to(cuda_device)
                            * fluid).to(torch.bfloat16))
        outs[mode] = make_run_fn(cfg)(st, sc, 4)
    got = [leaf for leaf in outs["cuda"] if leaf is not None]
    ref = [leaf for leaf in outs["eager"] if leaf is not None]
    assert got[1].dtype == torch.bfloat16
    _assert_bit_equal(got, ref, "state")


# C5a's inputs, in chains (float32 elements, bf16 pairs): whole groups of
# chains a thread; 1005, which leaves a ragged tail at 2, 4 and 8 chains a
# thread; and those at a 4-byte offset.
RATE_INPUTS = {"whole": (64 * 256, 0), "ragged": (1005, 0), "ragged_offset": (1005, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", RATE_INPUTS.values(), ids=RATE_INPUTS.keys())
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", cuda_dtype_probes.RATE_MODES)
def test_cuda_dtype_rate_matches_plain(cuda_device, mode, dtype, inputs):
    from fluid2d_tpu_torch.scripts.vpu_dtype_probe import check_dtype_rate

    chains, offset = inputs
    n = chains * (2 if dtype == torch.bfloat16 else 1)
    skip = offset // dtype.itemsize
    gen = torch.Generator(device="cpu").manual_seed(chains)
    flat = (2.0 + torch.rand(n + skip, generator=gen)).to(dtype).to(cuda_device)
    x = flat[skip:].view(1, n)
    assert x.data_ptr() % 16 == offset
    before = _runs(cuda_dtype_probes.dtype_rate_cuda)
    res = check_dtype_rate(mode, dtype, cuda_device, passes=3072, x=x)
    assert _runs(cuda_dtype_probes.dtype_rate_cuda) == before + 2
    assert res["max_err_ulps"] <= res["tol_ulps"] < res["one_step_off_min_ulps"]
    assert res["max_err_ulps_deep"] <= res["tol_ulps"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", cuda_dtype_probes.COPY_MODES)
def test_cuda_row_copy_bit_equal(cuda_device, mode, dtype):
    x = (torch.arange(256 * 256, dtype=torch.float32).reshape(256, 256) * 1e-4).to(dtype)
    got = cuda_dtype_probes.row_copy_cuda(x.to(cuda_device), mode)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_dtype_probes.row_copy_plain(x, mode))
    with pytest.raises(ValueError, match="16-byte"):
        cuda_dtype_probes.row_copy_cuda(x.to(cuda_device)[:, 1:].contiguous(), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["cip_dye_phase", "sor_iteration_f32in_v_limit",
                                 "jacobi_iteration_n4_f32out"])
def test_cuda_bf16_mix_twin_bit_equal(cuda_device, mix):
    ops = profiling.twin_operands(mix, 2 * RAGGED_RES, RAGGED_RES, cuda_device, "bfloat16")
    before = (_runs(cuda_probes.mix_twin_cuda), _runs(cuda_probes.mix_twin_bf16_cuda))
    got = cuda_probes.mix_twin_cuda(ops)
    torch.cuda.synchronize()
    assert (_runs(cuda_probes.mix_twin_cuda),
            _runs(cuda_probes.mix_twin_bf16_cuda)) == (before[0], before[1] + 1)
    _assert_bit_equal(got, cuda_probes.mix_twin_plain(ops), mix)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_wrong_operands(cuda_device):
    wrapper, _, args, kwargs = _kernel_calls(RES, cuda_device)[2]  # confinement
    v, va, fluid8, *rest = args
    with pytest.raises(TypeError, match="dtype"):
        wrapper(v, va.double(), fluid8, *rest, **kwargs)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(v, va.transpose(1, 2).contiguous().transpose(1, 2), fluid8, *rest, **kwargs)
    with pytest.raises(ValueError, match="on cpu"):
        wrapper(v, va.cpu(), fluid8, *rest, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("config", [
    {},
    {"scheme": "upwind"},
    {"scheme": "kk"},
    {"pressure_solver": "jacobi"},
    {"scheme": "kk", "pressure_solver": "jacobi", "n_pressure_iter": 6},
    {"scheme": "upwind", "n_pressure_iter": 3},
], ids=["cip", "upwind", "kk", "cip_jacobi", "kk_jacobi6", "upwind_sor3"])
def test_cuda_run_matches_eager_run(cuda_device, config):
    """4 steps through the kernels against 4 through the plain versions,
    from a seeded smooth state, every leaf within 2e-5·max(1, |ref|max)."""
    res = RES
    sc = get_scene(2, res, cuda_device)
    x_rows, y_cols = sc.shape
    fluid = (sc.mask == 0).float()
    gx = torch.linspace(0, 2 * np.pi, x_rows, device=cuda_device)[:, None]
    gy = torch.linspace(0, 2 * np.pi, y_cols, device=cuda_device)[None, :]
    outs = {}
    for mode in ("cuda", "eager"):
        cfg = SimConfig.create(resolution=res, kernels=mode, **config)
        st = init_state(sc, cfg, cuda_device)
        st = st._replace(
            v=torch.stack([0.3 * torch.sin(gx) * torch.cos(2 * gy) * fluid,
                           0.2 * torch.cos(2 * gx) * torch.sin(gy) * fluid]),
            p=0.1 * torch.sin(gx + gy) * fluid,
            dye=torch.stack([0.5 + 0.4 * torch.sin(k * gx) * torch.cos(gy) * fluid
                             for k in (1, 2, 3)]),
        )
        outs[mode] = make_run_fn(cfg)(st, sc, 4)
    got = [leaf for leaf in outs["cuda"] if leaf is not None]
    ref = [leaf for leaf in outs["eager"] if leaf is not None]
    _assert_close([g.float() for g in got], [r.float() for r in ref], "state", 2e-5)


@pytest.mark.cuda
def test_cuda_kk800_step100_bit_equal_to_eager_run(cuda_device):
    """The benchmark's kk800 settings at their own size (scene 2 at
    1600×800, KK, Re 1000, dt 0.0125/800, confinement 5, dye, SOR ω 1.3
    ×2, limit 10): one ``step(100)`` through the kernels bit-equal to 100
    eager steps, from a seeded smooth state, every leaf finite."""
    from fluid2d_tpu_torch import FluidSimulator

    res = 800
    kw = {"scheme": "kk", "re": 1000.0, "dt": 0.0125 / res, "vor_eps": 5.0}
    sc = get_scene(2, res, cuda_device)
    x_rows, y_cols = sc.shape
    fluid = (sc.mask == 0).float()
    gx = torch.linspace(0, 2 * np.pi, x_rows, device=cuda_device)[:, None]
    gy = torch.linspace(0, 2 * np.pi, y_cols, device=cuda_device)[None, :]
    outs = {}
    for mode in ("cuda", "eager"):
        cfg = SimConfig.create(resolution=res, kernels=mode, **kw)
        st = init_state(sc, cfg, cuda_device)
        st = st._replace(
            v=torch.stack([0.5 * torch.sin(3 * gx) * torch.cos(2 * gy) * fluid,
                           0.4 * torch.cos(2 * gx) * torch.sin(gy) * fluid]),
            p=0.05 * torch.sin(gx + gy) * fluid,
            dye=torch.stack([0.5 + 0.4 * torch.sin(k * gx) * torch.cos(gy) * fluid
                             for k in (1, 2, 3)]),
        )
        sim = FluidSimulator(sc, cfg, state=st)
        sim.step(100)
        torch.cuda.synchronize()
        outs[mode] = sim.state
    assert int(outs["cuda"].step) == 100
    for name, got, ref in zip(outs["cuda"]._fields, outs["cuda"], outs["eager"]):
        if got is None:
            continue
        assert bool(torch.isfinite(ref.float()).all()), name
        assert torch.equal(got, ref), name


def test_cuda_cip1600_jacobi6_step100_bit_equal_to_eager_run(cuda_device):
    """The benchmark's cip1600_jacobi6 settings at their own size (scene 2
    at 3200×1600, CIP, Re 1e6, dt 0.05/1600, confinement 5, dye, Jacobi ×6,
    limit 10): one ``step(100)`` on the graph path bit-equal to 100 eager
    steps, from a seeded smooth state, every leaf finite. The graph path
    counts two Jacobi launches a step, one of each form: 100 under
    ``f2d_jacobi_iteration.n4`` and 100 under ``.n2``. The eager path
    launches no kernel and counts none."""
    from fluid2d_tpu_torch import FluidSimulator

    res = 1600
    kw = {"pressure_solver": "jacobi", "n_pressure_iter": 6, "vor_eps": 5.0}
    sc = get_scene(2, res, cuda_device)
    outs = {}
    for mode in ("cuda", "eager"):
        cfg = SimConfig.create(resolution=res, kernels=mode, **kw)
        sim = FluidSimulator(sc, cfg, state=_seeded(cfg, sc, cuda_device))
        before = (launches["f2d_jacobi_iteration.n4"], launches["f2d_jacobi_iteration.n2"],
                  trace.entry_launches()["f2d_jacobi_iteration"])
        sim.step(100)
        torch.cuda.synchronize()
        moved = (launches["f2d_jacobi_iteration.n4"] - before[0],
                 launches["f2d_jacobi_iteration.n2"] - before[1],
                 trace.entry_launches()["f2d_jacobi_iteration"] - before[2])
        assert moved == ((100, 100, 200) if mode == "cuda" else (0, 0, 0)), mode
        assert (sim._graphs is not None) == (mode == "cuda")
        outs[mode] = sim.state
    assert int(outs["cuda"].step) == 100
    for name, got, ref in zip(outs["cuda"]._fields, outs["cuda"], outs["eager"]):
        if got is None:
            continue
        assert bool(torch.isfinite(ref.float()).all()), name
        assert torch.equal(got, ref), name


# --- the graph path of FluidSimulator.step (models/replay.py) ------------------

GRAPH_CONFIGS = {
    "cip": {},
    "upwind": {"scheme": "upwind", "re": 1000.0},
    "kk": {"scheme": "kk", "re": 1000.0},
    "cip_bf16": {"dtype": "bfloat16"},
    "kk_jacobi6_bf16": {"scheme": "kk", "pressure_solver": "jacobi", "n_pressure_iter": 6,
                        "dtype": "bfloat16"},
    "upwind_sor3_noconf": {"scheme": "upwind", "n_pressure_iter": 3, "vor_eps": None},
}


def _seeded(cfg, sc, device):
    """A smooth state of `cfg` on scene `sc`: the fluid cells moving, a
    pressure field and, with dye, three dye patterns."""
    x_rows, y_cols = sc.shape
    fluid = (sc.mask == 0).float()
    gx = torch.linspace(0, 2 * np.pi, x_rows, device=device)[:, None]
    gy = torch.linspace(0, 2 * np.pi, y_cols, device=device)[None, :]
    st = init_state(sc, cfg, device)
    dt = st.v.dtype
    st = st._replace(v=torch.stack([0.5 * torch.sin(3 * gx) * torch.cos(2 * gy) * fluid,
                                    0.4 * torch.cos(2 * gx) * torch.sin(gy) * fluid]).to(dt),
                     p=(0.05 * torch.sin(gx + gy) * fluid).to(dt))
    if st.dye is not None:
        st = st._replace(dye=torch.stack([0.5 + 0.4 * torch.sin(k * gx) * torch.cos(gy) * fluid
                                          for k in (1, 2, 3)]).to(dt))
    return st


def _clone(st):
    return st._replace(**{f: t.clone() for f, t in st._asdict().items() if t is not None})


def _assert_states_equal(got, ref, what):
    for name, g, r in zip(got._fields, got, ref):
        assert (g is None) == (r is None), f"{what}: {name}"
        if g is not None:
            assert g.dtype == r.dtype and torch.equal(g, r), f"{what}: {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 5, 100])
@pytest.mark.parametrize("config", GRAPH_CONFIGS.values(), ids=GRAPH_CONFIGS.keys())
def test_cuda_graph_run_bit_equal_to_eager_run(cuda_device, config, n):
    """n steps replayed from the graphs (the workspace filled with NaN before
    the capture, so a cell a kernel leaves unwritten shows) bit-equal to
    ``make_run_fn``'s eager loop through the same kernels, every leaf,
    alternates included; then n more from the layout reached."""
    from fluid2d_tpu_torch.models.replay import StepGraphs

    cfg = SimConfig.create(resolution=RES, **config)
    sc = scene_for_dtype(get_scene(2, RES, cuda_device), cfg)
    st = _seeded(cfg, sc, cuda_device)
    ref = make_run_fn(cfg)(_clone(st), sc, n)
    graphs = StepGraphs(st, sc, cfg, fill=float("nan"))
    got = graphs.run(st, n)
    torch.cuda.synchronize()
    _assert_states_equal(got, ref, f"{n} steps")
    assert graphs.locate(got) == n % 2
    ref = make_run_fn(cfg)(ref, sc, n)
    got = graphs.run(got, n)
    torch.cuda.synchronize()
    _assert_states_equal(got, ref, f"{n} + {n} steps")
    assert int(got.step) == 2 * n


@pytest.mark.cuda
@pytest.mark.parametrize("config", GRAPH_CONFIGS.values(), ids=GRAPH_CONFIGS.keys())
def test_cuda_graph_steps_7_then_5_equal_12(cuda_device, config):
    """``FluidSimulator.step(7)`` then ``step(5)`` on the graph path equal
    ``step(12)`` on it and 12 steps of the eager loop; the graphs are
    captured once, at the first call."""
    from fluid2d_tpu_torch import FluidSimulator

    cfg = SimConfig.create(resolution=RES, **config)
    sc = scene_for_dtype(get_scene(2, RES, cuda_device), cfg)
    st = _seeded(cfg, sc, cuda_device)
    ref = make_run_fn(cfg)(_clone(st), sc, 12)
    a, b = FluidSimulator(sc, cfg, state=_clone(st)), FluidSimulator(sc, cfg, state=_clone(st))
    captures = trace.graph_captures
    a.step(7)
    assert trace.graph_captures > captures
    captures = trace.graph_captures
    a.step(5)
    assert trace.graph_captures == captures
    b.step(12)
    torch.cuda.synchronize()
    _assert_states_equal(a.state, ref, "7 + 5")
    _assert_states_equal(b.state, ref, "12")


@pytest.mark.cuda
def test_cuda_graph_state_copied_once_after_reset_and_load(cuda_device, tmp_path):
    """A state in no layout is copied into the workspace once: after
    ``reset``, and after a loaded state is assigned; a simulator made by
    ``load`` takes its state's leaves as its buffers and copies nothing.
    Every path lands on the eager loop's values."""
    from fluid2d_tpu_torch import FluidSimulator

    sim = FluidSimulator.create(2, RES)
    sim.step(3)
    sim.save(tmp_path / "a.npz")
    copies = trace.graph_state_copies
    sim.reset()
    sim.step(2)
    sim.step(3)
    assert trace.graph_state_copies == copies + 1
    ref = make_run_fn(sim.cfg)(init_state(sim.scene, sim.cfg, cuda_device), sim.scene, 5)
    _assert_states_equal(sim.state, ref, "reset + 5")
    loaded = FluidSimulator.load(tmp_path / "a.npz")
    copies = trace.graph_state_copies
    sim.state = loaded.state._replace(**{f: t.clone() for f, t in loaded.state._asdict().items()
                                         if t is not None})
    sim.step(4)
    assert trace.graph_state_copies == copies + 1
    loaded.step(4)
    assert trace.graph_state_copies == copies + 1
    torch.cuda.synchronize()
    _assert_states_equal(sim.state, loaded.state, "load + 4")
    assert sim.step_count == 7


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["cip", "upwind", "kk"])
def test_cuda_graph_launches_per_step_equal_eager(cuda_device, scheme):
    """The launch counter moves by the same counts a step, by entry point,
    on the graph path (replays add their graphs' launches; a capture adds
    none) as on the eager loop."""
    from fluid2d_tpu_torch import FluidSimulator

    sim = FluidSimulator.create(2, RES, scheme=scheme)
    run = make_run_fn(sim.cfg)
    steps = 7
    before = trace.entry_launches()
    run(_clone(sim.state), sim.scene, steps)
    eager = trace.entry_launches()
    eager.subtract(before)
    for warm in (True, False):
        before = trace.entry_launches()
        sim.step(steps)
        got = trace.entry_launches()
        got.subtract(before)
        assert +got == +eager, ("first call" if warm else "replays only", got, eager)


@pytest.mark.cuda
@pytest.mark.parametrize(("bc", "res", "scheme"), [(1, 400, "upwind"), (2, RES, "cip")])
def test_cuda_graph_frames_run_no_eager_steps(cuda_device, bc, res, scheme):
    """The view's frame loop (``step(5)``, render, 8-bit image) after its
    warm-up: no eager step on the card, no state copy, no capture; each
    frame's steps are replays."""
    from fluid2d_tpu_torch import FluidSimulator
    from fluid2d_tpu_torch.utils.viz import to_image

    sim = FluidSimulator.create(bc, res, scheme=scheme)
    for _ in range(2):
        sim.step(5)
        to_image(sim.render(0))
    counts = (trace.eager_cuda_steps, trace.graph_state_copies, trace.graph_captures)
    replays = sum(trace.graph_replays.values())
    for _ in range(6):
        sim.step(5)
        img = to_image(sim.render(0))
    assert img.shape == (sim.scene.shape[1], sim.scene.shape[0], 3)
    assert (trace.eager_cuda_steps, trace.graph_state_copies, trace.graph_captures) == counts
    assert sum(trace.graph_replays.values()) > replays
    assert sim.step_count == 40


@pytest.mark.cuda
@pytest.mark.parametrize("config", [{"kernels": "eager"}, {"n_pressure_iter": 0}],
                         ids=["kernels_eager", "no_pressure_solve"])
def test_cuda_graph_path_stays_off_where_it_does_not_engage(cuda_device, config):
    """``kernels="eager"`` and a step with no pressure solve run the eager
    loop on the card: each step counted in ``eager_cuda_steps``, nothing
    replayed or captured, the values the eager loop's."""
    from fluid2d_tpu_torch import FluidSimulator

    sim = FluidSimulator.create(2, RES, **config)
    st = _clone(sim.state)
    eager, replays = trace.eager_cuda_steps, sum(trace.graph_replays.values())
    captures = trace.graph_captures
    sim.step(3)
    assert trace.eager_cuda_steps == eager + 3
    assert sum(trace.graph_replays.values()) == replays and trace.graph_captures == captures
    _assert_states_equal(sim.state, make_run_fn(sim.cfg)(st, sim.scene, 3), "eager loop")


# --- the roofline's probes (C2-C4) ----------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4 * 1000, 4 * 1000 + 3, 1, 2])
def test_cuda_copy_add1_is_bit_equal(cuda_device, n):
    """C2 over whole float4s and a ragged tail: bit-equal to x + 1."""
    gen = torch.Generator(device="cpu").manual_seed(n)
    x = torch.randn(n, generator=gen).to(cuda_device)
    before = _runs(cuda_probes.copy_add1_cuda)
    got = cuda_probes.copy_add1_cuda(x)
    out = torch.empty_like(x)
    into = cuda_probes.copy_add1_cuda(x, out=out)
    torch.cuda.synchronize()
    assert _runs(cuda_probes.copy_add1_cuda) == before + 2
    assert into is out
    assert torch.equal(got, x + 1) and torch.equal(out, x + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["cip_dye_phase", "sor_iteration_v_limit"])
def test_cuda_mix_twin_matches_plain(cuda_device, mix):
    """C3 on two registered mixes at a ragged grid: within 1e-5 of the
    plain sum (the same additions in the same order)."""
    ops = profiling.twin_operands(mix, 2 * RAGGED_RES, RAGGED_RES, cuda_device)
    before = (_runs(cuda_probes.mix_twin_cuda), _runs(cuda_probes.mix_twin_bf16_cuda))
    got = cuda_probes.mix_twin_cuda(ops)
    torch.cuda.synchronize()
    assert (_runs(cuda_probes.mix_twin_cuda),
            _runs(cuda_probes.mix_twin_bf16_cuda)) == (before[0] + 1, before[1])
    assert len(got) == sum(profiling._KERNEL_MIXES[mix]["f_out"])
    _assert_close(got, cuda_probes.mix_twin_plain(ops), mix, 1e-5)


@pytest.mark.cuda
def test_cuda_fma_rate_matches_plain_at_shallow_depth(cuda_device):
    """C4 at 64 passes: one rounding per FMA against the plain version's
    two, within 1e-5·max(1, |ref|max)."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    x = torch.rand((256, 1024), generator=gen).to(cuda_device)
    before = _runs(cuda_probes.fma_rate_cuda)
    got = cuda_probes.fma_rate_cuda(x, 64)
    torch.cuda.synchronize()
    assert _runs(cuda_probes.fma_rate_cuda) == before + 1
    _assert_close([got], [cuda_probes.fma_rate_plain(x, 64)], "fma_rate", 1e-5)
    with pytest.raises(AssertionError, match="max error"):  # one round short is seen
        _assert_close([got], [cuda_probes.fma_rate_plain(x, 56)], "fma_rate", 1e-5)


@pytest.mark.cuda
def test_cuda_fma_rate_within_rounding_bound_at_full_depth(cuda_device):
    """C4 at the timed 8192 passes against the plain version in float64:
    within fma_rate_error_bound, and one round short is beyond it."""
    gen = torch.Generator(device="cpu").manual_seed(8)
    x = torch.rand((64, 1024), generator=gen).to(cuda_device)
    got = cuda_probes.fma_rate_cuda(x, 8192).double()
    bound = cuda_probes.fma_rate_error_bound(x, 8192)
    assert float((got - cuda_probes.fma_rate_plain(x.double(), 8192)).abs().max()) <= bound
    assert float((got - cuda_probes.fma_rate_plain(x.double(), 8184)).abs().min()) > bound


@pytest.mark.cuda
def test_cuda_probe_measurements_are_positive(cuda_device):
    assert profiling.measure_hbm_bandwidth(mbytes=64, iters=20, device=cuda_device) > 0
    rate, nbytes = profiling.measure_mix_ceiling("confinement", 128, 64, iters=10,
                                                 device=cuda_device)
    assert rate > 0 and nbytes == profiling.mix_bytes("confinement", 128, 64)
    assert profiling.measure_fma_throughput(passes=64, iters=2, device=cuda_device) > 0


# --- C1, the last probes (C5d–g) and the el-op toys (C6) ------------------------


# C1's grids: scene 2 at whole and ragged tiles, and open scenes (fluid on
# every edge cell, so window entries past the grid decide outputs) of odd
# shape (Y % 4 != 0: element-by-element fills) and of whole chunks.
ADVECT_GRIDS = {"scene2": (2, RES), "scene2_ragged": (2, RAGGED_RES),
                "open_odd": (None, (75, 37)), "open_chunk_rows": (None, (66, 36))}


def _advect_args(grid, dtype: torch.dtype, self_advect: bool, device):
    """Seeded inputs of the standalone advection on `grid` (ADVECT_GRIDS):
    the dye form (C = 3, a separate velocity) or the velocity form (C = 2,
    vel is f)."""
    bc, size = grid
    gen = torch.Generator(device="cpu").manual_seed(int(np.sum(size)) + 7)
    if bc is None:
        shape = size
        fluid8 = (torch.rand(shape, generator=gen) > 0.2).to(torch.int8)
        fluid8[0], fluid8[-1], fluid8[:, 0], fluid8[:, -1] = 1, 1, 1, 1
        fluid8 = fluid8.to(device)
        res = size[1]
    else:
        sc = get_scene(bc, size, device)
        shape, fluid8, res = sc.shape, sc.fluid8, size
    chans = 2 if self_advect else 3

    def rnd(lead, scale):
        return (scale * torch.randn((lead, *shape), generator=gen)).to(dtype).to(device)

    f, fx, fy = rnd(chans, 8.0 if self_advect else 0.5), rnd(chans, 0.1), rnd(chans, 0.1)
    vel = f if self_advect else rnd(2, 8.0)
    alts = [rnd(chans, 0.5) for _ in range(3)]
    cfg = SimConfig.create(resolution=res)
    return (f, fx, fy, vel, *alts, fluid8, cfg.dt, cfg.dx)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ADVECT_GRIDS.values(), ids=ADVECT_GRIDS.keys())
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("self_advect", [False, True], ids=["dye_form", "velocity_form"])
def test_cuda_cip_advect_matches_plain(cuda_device, self_advect, dtype, grid):
    """C1 against its plain version: bit-equal at both dtypes and both forms,
    one launch a call, into fresh outputs or the `out=` given; an output
    aliasing an input raises before any launch."""
    from fluid2d_tpu_torch.ops.cuda_stencil import cip_advect_cuda, cip_advect_plain

    args = _advect_args(grid, dtype, self_advect, cuda_device)
    ref = cip_advect_plain(*args)
    before = _runs(cip_advect_cuda)
    got = cip_advect_cuda(*args)
    torch.cuda.synchronize()
    assert _runs(cip_advect_cuda) == before + 1
    _assert_bit_equal(got, ref, "cip_advect")
    out = tuple(torch.full_like(args[0], float("nan")) for _ in range(3))
    got = cip_advect_cuda(*args, out=out)
    torch.cuda.synchronize()
    assert _runs(cip_advect_cuda) == before + 2 and all(g is o for g, o in zip(got, out))
    _assert_bit_equal(got, ref, "cip_advect out=")
    with pytest.raises(ValueError, match="aliases"):
        cip_advect_cuda(*args, out=(args[4], torch.empty_like(args[0]), torch.empty_like(args[0])))
    assert _runs(cip_advect_cuda) == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [64, 1024])
@pytest.mark.parametrize("nchain", cuda_probes.FMA_SWEEP_CHAINS)
def test_cuda_fma_sweep_within_bound(cuda_device, nchain, threads):
    """C5d at the sweep's shallowest and deepest depth: within
    fma_rate_error_bound of the float64 plain version, one round short beyond it."""
    from fluid2d_tpu_torch.scripts.vpu_rate_sweep import check_chains

    x = torch.rand((64, 1024), generator=torch.Generator().manual_seed(nchain)).to(cuda_device)
    before = _runs(cuda_probes.fma_sweep_cuda)
    for depth in (64, 1024):
        res = check_chains(x, nchain, depth, threads)
        assert res["max_abs_err"] <= res["bound"] < res["one_round_short_min_err"]
    assert _runs(cuda_probes.fma_sweep_cuda) == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h", [0, 1, 8])
def test_cuda_geometry_twin_matches_plain(cuda_device, h, channels):
    """C5e/f on a ragged grid, with shared and int8 planes: within
    1e-5·max(1, |ref|max) of the plain sum (the same additions in order)."""
    x, y = 2 * RAGGED_RES, RAGGED_RES
    gen = torch.Generator(device="cpu").manual_seed(h + channels)
    lead = (channels,) if channels > 1 else ()
    ops = cuda_probes.GeometryOperands(
        [torch.randn((*lead, x, y), generator=gen).to(cuda_device) for _ in range(3)],
        shared_in=[torch.randn((x, y), generator=gen).to(cuda_device)],
        i8_in=[torch.randint(-3, 4, (x, y), generator=gen, dtype=torch.int8).to(cuda_device)],
        n_out=2, h=h, block_rows=4)
    before = _runs(cuda_probes.geometry_twin_cuda)
    got = cuda_probes.geometry_twin_cuda(ops)
    torch.cuda.synchronize()
    assert _runs(cuda_probes.geometry_twin_cuda) == before + 1
    _assert_close(got, cuda_probes.geometry_twin_plain(ops), "geometry_twin", 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3200, 1600), (256, 64)], ids=["3200x1600", "256x64"])
def test_cuda_row_window_bit_equal(cuda_device, shape):
    """C5g: the bulk-copied windows give 2·a to the bit, edge tiles included."""
    x_rows, y_cols = shape
    t = cuda_probes.row_window_tile(x_rows, y_cols)
    a = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    got = cuda_probes.row_window_cuda(a, t)
    torch.cuda.synchronize()
    assert torch.equal(got, 2.0 * a)
    assert torch.equal(got, cuda_probes.row_window_plain(a, t))


@pytest.mark.cuda
@pytest.mark.parametrize("per_block", [1, 2, 8])
def test_cuda_row_window_persistent_blocks(cuda_device, per_block):
    """C5g at Y = 1600 (a ring of 4 groups fills an SM, one block an SM) on
    planes of 1, 2 and 8 tiles of 16 rows a persistent block: every ring
    slot refilled 0, 1 and 7 times; one launch, bit-equal to 2·a and to the
    plain windows."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    shape = (16 * sms * per_block, 1600)
    assert cuda_probes.row_window_tile(*shape) == 16 and cuda_probes.row_window_slots(1600) == 4
    a = torch.randn(shape, generator=torch.Generator().manual_seed(per_block)).to(cuda_device)
    before = _runs(cuda_probes.row_window_cuda)
    got = cuda_probes.row_window_cuda(a, 16)
    torch.cuda.synchronize()
    assert _runs(cuda_probes.row_window_cuda) == before + 1
    assert torch.equal(got, 2.0 * a)
    assert torch.equal(got, cuda_probes.row_window_plain(a, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 128), (8, 128), (3200, 1600)])
@pytest.mark.parametrize("op", cuda_probes.TOY_OPS)
def test_cuda_toy_elementwise_bit_equal(cuda_device, op, shape):
    """C6: each toy bit-equal to its plain version on the card (the division
    as PyTorch's CUDA division by a Python scalar rounds it)."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    before = _runs(cuda_probes.toy_elementwise_cuda)
    got = cuda_probes.toy_elementwise_cuda(x, op)
    torch.cuda.synchronize()
    assert _runs(cuda_probes.toy_elementwise_cuda) == before + 1
    assert torch.equal(got, cuda_probes.toy_elementwise_plain(x, op))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("n", [4 * 1000 + 1, 4 * 1000 + 2, 4 * 1000 + 3, 1, 2, 3, 4 * 1000])
@pytest.mark.parametrize("op", cuda_probes.TOY_OPS)
def test_cuda_toy_elementwise_ragged_and_misaligned(cuda_device, op, n, offset):
    """C6's vector stream with a ragged tail (n % 4 = 1, 2, 3), shorter than
    one float4, and on a view at offset 1 (not 16-byte aligned: the kernel's
    scalar path): one launch, bit-equal to the plain version."""
    base = torch.randn(n + 1, generator=torch.Generator().manual_seed(n)).to(cuda_device)
    x = base[offset:offset + n]
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = _runs(cuda_probes.toy_elementwise_cuda)
    got = cuda_probes.toy_elementwise_cuda(x, op)
    torch.cuda.synchronize()
    assert _runs(cuda_probes.toy_elementwise_cuda) == before + 1
    assert torch.equal(got, cuda_probes.toy_elementwise_plain(x, op))


# The fused CIP phases (one launch a phase on tiles with a recomputed halo)
# where the tiling could go wrong: a grid smaller than one tile, one that is
# not a multiple of it, scene 3's one-column outflow and scene 1's walls.
# The kernels' row access depends on Y: element by element (Y % 4 != 0),
# aligned 4-element chunks (Y % 4 == 0), and at bf16 16-byte pairs
# (Y % 8 == 0); the last three grids take the aligned copies and vector
# stores on ragged tiles, beside the scalar edge chunks.
FUSED_GRIDS = {"smaller_than_tile": (3, 6), "ragged": (2, 37), "scene3_outflow": (3, 64),
               "scene1_walls": (1, 37), "chunk_rows_ragged": (2, 36),
               "chunk_rows_scene3": (3, 100), "pair_rows_ragged": (2, 40)}


def _cip_phase_call(phase: str, bc: int, res: int, dtype: torch.dtype, device):
    """(wrapper, plain version, args) of the CIP phase on seeded inputs of
    scene `bc` at `res`, state and scene in `dtype`."""
    cfg = SimConfig.create(resolution=res, re=1000.0, dtype=str(dtype).removeprefix("torch."))
    sc = scene_for_dtype(get_scene(bc, res, device), cfg)
    gen = torch.Generator(device="cpu").manual_seed(10 * bc + res)

    def rnd(lead, scale, offset=0.0):
        t = offset + scale * torch.randn((*lead, *sc.shape), generator=gen)
        return t.to(dtype).to(device)

    v = rnd((2,), 3.0)
    if phase == "velocity":
        args = (v, rnd((), 0.3), rnd((2,), 0.5), *(rnd((2,), 0.1) for _ in range(4)), sc,
                cfg.re, cfg.dt, cfg.dx)
        return cuda_phases.cip_velocity_phase_cuda, cuda_phases.cip_velocity_phase_plain, args
    args = (rnd((3,), 0.5, 0.5), rnd((3,), 0.5, 0.5), *(rnd((3,), 0.1) for _ in range(4)), v, sc,
            cfg.re, cfg.dt, cfg.dx)
    return cuda_phases.cip_dye_phase_cuda, cuda_phases.cip_dye_phase_plain, args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grid", FUSED_GRIDS.values(), ids=FUSED_GRIDS.keys())
@pytest.mark.parametrize("phase", ["velocity", "dye"])
def test_cuda_fused_cip_phase_bit_equal_to_plain(cuda_device, phase, grid, dtype):
    """One launch, six output allocations and no scratch, every output equal
    to the plain version's to the bit at float32 and bf16."""
    wrapper, plain, args = _cip_phase_call(phase, *grid, dtype, cuda_device)
    before = _runs(wrapper)
    allocs = torch.cuda.memory_stats(cuda_device).get("allocation.all.allocated", 0)
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert _runs(wrapper) == before + 1
    assert torch.cuda.memory_stats(cuda_device)["allocation.all.allocated"] - allocs == 6
    _assert_bit_equal(got, plain(*args), f"cip_{phase}_phase")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bc", [3, 1], ids=["scene3_outflow", "scene1_walls"])
@pytest.mark.parametrize("kernel", ["cip_advect", "mac_velocity_upwind", "mac_velocity_kk",
                                    "mac_dye_upwind", "mac_dye_kk"])
def test_cuda_shared_cell_rules_bit_equal_to_plain(cuda_device, kernel, bc, dtype):
    """C1 (the CIP advection cell) and B2/B3 (the BC cell rules) share their
    per-cell functions with the fused phases: bit-equal to their plain
    versions on the outflow and wall scenes, at both dtypes."""
    res = 37
    cfg = SimConfig.create(resolution=res, re=1000.0, dtype=str(dtype).removeprefix("torch."))
    sc = scene_for_dtype(get_scene(bc, res, cuda_device), cfg)
    gen = torch.Generator(device="cpu").manual_seed(bc + 50)

    def rnd(lead, scale, offset=0.0):
        t = offset + scale * torch.randn((*lead, *sc.shape), generator=gen)
        return t.to(dtype).to(cuda_device)

    v, p, dye = rnd((2,), 3.0), rnd((), 0.3), rnd((3,), 0.5, 0.5)
    if kernel == "cip_advect":
        wrapper, plain = cuda_stencil.cip_advect_cuda, cuda_stencil.cip_advect_plain
        args = (dye, *(rnd((3,), 0.1) for _ in range(2)), v, *(rnd((3,), 0.5) for _ in range(3)),
                sc.fluid8, cfg.dt, cfg.dx)
    elif kernel.startswith("mac_velocity"):
        wrapper, plain = cuda_phases.mac_velocity_phase_cuda, cuda_phases.mac_velocity_phase_plain
        args = (v, p, rnd((2,), 0.5), sc, kernel.rsplit("_", 1)[1], cfg.re, cfg.dt, cfg.dx)
    else:
        wrapper, plain = cuda_phases.mac_dye_phase_cuda, cuda_phases.mac_dye_phase_plain
        args = (dye, rnd((3,), 0.5, 0.5), v, sc, kernel.rsplit("_", 1)[1], cfg.dt, cfg.dx)
    got = wrapper(*args)
    torch.cuda.synchronize()
    _assert_bit_equal(got, plain(*args), kernel)


# The fused SOR and confinement (one launch a call on tiles with a recomputed
# halo) on the fused CIP phases' grids and an open scene, where fluid reaches
# the grid's edge and the stage values of window entries past it decide the
# edge cells. Links: the pair read and returned (float32 state: float32).
SOR_LINKS = {"f32": (torch.float32, None, None), "bf16_bf16": (torch.bfloat16, None, None),
             "bf16_f32": (torch.bfloat16, None, torch.float32),
             "f32_bf16": (torch.bfloat16, torch.float32, torch.bfloat16),
             "f32_f32": (torch.bfloat16, torch.float32, torch.float32)}
TILE_GRIDS = {**FUSED_GRIDS, "open": (None, 37), "open_chunk_rows": (None, 36)}


def _edge_codes(shape, codes: int, device) -> torch.Tensor:
    """int8 codes 1..codes in turn along the first and last rows and
    columns of `shape`, 0 inside: every code of a BC at the grid's edge."""
    x, y = shape
    code = torch.zeros(shape, dtype=torch.int8)
    cyc = torch.arange(2 * (x + y)) % codes + 1
    code[0], code[-1] = cyc[:y], cyc[1:y + 1]
    code[:, 0], code[:, -1] = cyc[2:x + 2], cyc[3:x + 3]
    return code.to(device)


def _pressure_call(bc, res, dtype, device):
    """Seeded (p, p_alt, u, w, v, v_alt) and (cfg, pbc_code, fluid8,
    not_wall8) of scene `bc` at `res` in `dtype`; None: the open scene (no
    BC), "edge": the open scene with the pressure BC codes 1..10 on its
    edge."""
    cfg = SimConfig.create(resolution=res, dtype=str(dtype).removeprefix("torch."))
    if bc in (None, "edge"):
        shape = (2 * res, res)
        code = (torch.zeros(shape, dtype=torch.int8, device=device) if bc is None
                else _edge_codes(shape, 10, device))
        fluid = not_wall = torch.ones(shape, dtype=torch.int8, device=device)
    else:
        sc = get_scene(bc, res, device)
        shape, code, fluid, not_wall = sc.shape, sc.pbc_code, sc.fluid8, sc.not_wall8
    gen = torch.Generator(device="cpu").manual_seed(20 * (bc if isinstance(bc, int) else 0) + res)

    def rnd(lead, scale):
        return (scale * torch.randn((*lead, *shape), generator=gen)).to(dtype).to(device)

    fields = (rnd((), 0.3), rnd((), 0.3), rnd((), 8.0), rnd((), 8.0), rnd((2,), 3.0),
              rnd((2,), 0.5))
    return fields, (cfg, code, fluid, not_wall)


def _allocations(device) -> int:
    return torch.cuda.memory_stats(device).get("allocation.all.allocated", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("v_limit", [None, 10.0], ids=["plain", "v_limit"])
@pytest.mark.parametrize("n_iters", [1, 2])
@pytest.mark.parametrize("link", SOR_LINKS)
@pytest.mark.parametrize("grid", TILE_GRIDS.values(), ids=TILE_GRIDS.keys())
def test_cuda_fused_sor_bit_equal_to_plain(cuda_device, grid, link, n_iters, v_limit):
    """One launch, only the outputs allocated, every output equal to the
    plain version's to the bit."""
    state, pair_in, pair_out = SOR_LINKS[link]
    (p, pa, u, w, _, _), (cfg, code, fluid, _) = _pressure_call(*grid, state, cuda_device)
    if pair_in is not None:
        p, pa = p.to(pair_in), pa.to(pair_in)
    args = (p, pa, u, w, code, fluid, cfg.sor_omega, cfg.dt, cfg.dx)
    kw = {"n_iters": n_iters, "v_limit": v_limit, "out_dtype": pair_out}
    before, allocs = _runs(cuda_stencil.sor_iteration_cuda), _allocations(cuda_device)
    got = cuda_stencil.sor_iteration_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert _runs(cuda_stencil.sor_iteration_cuda) == before + 1
    assert _allocations(cuda_device) - allocs == len(got)
    _assert_bit_equal(got, cuda_stencil.sor_iteration_plain(*args, **kw), f"sor{n_iters}_{link}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grid", TILE_GRIDS.values(), ids=TILE_GRIDS.keys())
def test_cuda_fused_confinement_bit_equal_to_plain(cuda_device, grid, dtype):
    """One launch, one output allocation (no scratch), bit-equal; the
    alternate passes through."""
    (*_, v, va), (cfg, _, fluid, _) = _pressure_call(*grid, dtype, cuda_device)
    args = (v, va, fluid, cfg.dt, 5.0, cfg.dx)
    before, allocs = _runs(cuda_phases.confinement_cuda), _allocations(cuda_device)
    got = cuda_phases.confinement_cuda(*args)
    torch.cuda.synchronize()
    assert _runs(cuda_phases.confinement_cuda) == before + 1
    assert _allocations(cuda_device) - allocs == 1 and got[1] is v
    _assert_bit_equal(got, cuda_phases.confinement_plain(*args), "confinement")


# The fused Jacobi iteration (B1: one launch a call of 1..4 iterations) on
# the fused SOR's grids and an open scene with every pressure BC code on its
# edge, where the BC'd entries past the grid decide the edge cells.
JACOBI_GRIDS = {**TILE_GRIDS, "open_edge_codes": ("edge", 37)}


@pytest.mark.cuda
@pytest.mark.parametrize("v_limit", [None, 10.0], ids=["plain", "v_limit"])
@pytest.mark.parametrize("n_iters", [1, 2, 3, 4])
@pytest.mark.parametrize("link", SOR_LINKS)
@pytest.mark.parametrize("grid", JACOBI_GRIDS.values(), ids=JACOBI_GRIDS.keys())
def test_cuda_fused_jacobi_bit_equal_to_plain(cuda_device, grid, link, n_iters, v_limit):
    """One launch, only the outputs allocated, every output equal to the
    plain version's to the bit."""
    state, pair_in, pair_out = SOR_LINKS[link]
    (p, pa, u, w, _, _), (cfg, code, _, not_wall) = _pressure_call(*grid, state, cuda_device)
    if pair_in is not None:
        p, pa = p.to(pair_in), pa.to(pair_in)
    args = (p, pa, u, w, code, not_wall, cfg.dt, cfg.dx)
    kw = {"n_iters": n_iters, "v_limit": v_limit, "out_dtype": pair_out}
    wrapper = cuda_stencil.jacobi_iteration_cuda
    before, allocs = _runs(wrapper), _allocations(cuda_device)
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert _runs(wrapper) == before + 1
    assert _allocations(cuda_device) - allocs == len(got)
    _assert_bit_equal(got, cuda_stencil.jacobi_iteration_plain(*args, **kw),
                      f"jacobi{n_iters}_{link}")


@pytest.mark.cuda
def test_cuda_jacobi_entry_refuses_wrong_operands(cuda_device):
    """The one storage-flag entry point refuses an iteration count outside
    1..4, pairs other than the velocity's dtype or float32, and mixed pair
    dtypes; nothing is launched."""
    (p, pa, u, w, _, _), (cfg, code, _, not_wall) = _pressure_call(2, 37, torch.bfloat16,
                                                                    cuda_device)
    wrapper = cuda_stencil.jacobi_iteration_cuda
    before = _runs(wrapper)
    args = (code, not_wall, cfg.dt, cfg.dx)
    with pytest.raises(ValueError, match="1..4"):
        wrapper(p, pa, u, w, *args, n_iters=5)
    with pytest.raises(TypeError, match="p_cur"):
        wrapper(p.half(), pa.half(), u, w, *args)
    with pytest.raises(TypeError, match="p_alt"):
        wrapper(p, pa.float(), u, w, *args)
    with pytest.raises(TypeError, match="u, w"):
        wrapper(p, pa, u, w.float(), *args)
    with pytest.raises(ValueError, match="shape"):
        wrapper(p, pa, u, w, code[:, :-1].contiguous(), not_wall, cfg.dt, cfg.dx)
    assert _runs(wrapper) == before


# The fused MAC dye phase (B3: one launch a call on tiles with a recomputed
# halo of 1 or 2) on the fused phases' grids, an open scene with fluid and
# inflow to the grid's edge (the BC'd values past the grid decide the edge
# cells) and the main path's 3200×1600.
MAC_DYE_GRIDS = {**TILE_GRIDS, "main_3200x1600": (2, 1600)}


def _mac_dye_call(bc, res, dtype, scheme, device):
    """Seeded (dye, dye_alt, vel, scene, scheme, dt, dx) of scene `bc` at
    `res` (None: the open scene) in `dtype`."""
    cfg = SimConfig.create(resolution=res, dtype=str(dtype).removeprefix("torch."))
    sc = scene_for_dtype(get_scene(2 if bc is None else bc, res, device), cfg)
    if bc is None:
        inflow = torch.zeros(sc.shape, dtype=torch.bool, device=device)
        inflow[0], inflow[-1], inflow[:, 0] = True, True, True
        fluid = torch.ones(sc.shape, dtype=torch.bool, device=device)
        sc = sc._replace(fluid=fluid, fluid8=fluid.to(torch.int8), inflow=inflow,
                         inflow8=inflow.to(torch.int8))
    gen = torch.Generator(device="cpu").manual_seed(30 * (bc or 7) + res)

    def rnd(lead, scale, offset=0.0):
        t = offset + scale * torch.randn((*lead, *sc.shape), generator=gen)
        return t.to(dtype).to(device)

    return rnd((3,), 0.5, 0.5), rnd((3,), 0.5, 0.5), rnd((2,), 30.0), sc, scheme, cfg.dt, cfg.dx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scheme", ["upwind", "kk"])
@pytest.mark.parametrize("grid", MAC_DYE_GRIDS.values(), ids=MAC_DYE_GRIDS.keys())
def test_cuda_fused_mac_dye_bit_equal_to_plain(cuda_device, grid, scheme, dtype):
    """One launch, two output allocations (no float scratch at bf16), both
    outputs equal to the plain version's to the bit."""
    args = _mac_dye_call(*grid, dtype, scheme, cuda_device)
    wrapper = cuda_phases.mac_dye_phase_cuda
    before, allocs = _runs(wrapper), _allocations(cuda_device)
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert _runs(wrapper) == before + 1
    assert _allocations(cuda_device) - allocs == 2
    _assert_bit_equal(got, cuda_phases.mac_dye_phase_plain(*args), f"mac_dye_{scheme}")


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 5])
def test_cuda_fused_mac_dye_any_channel_count(cuda_device, channels):
    """A block takes every channel of its tile: one and five channels too."""
    dye, dye_alt, vel, sc, scheme, dt, dx = _mac_dye_call(2, 37, torch.float32, "kk", cuda_device)
    sc = sc._replace(bc_dye=sc.bc_dye[:1].repeat(channels, 1, 1).contiguous())
    args = (dye[:1].repeat(channels, 1, 1) * torch.arange(1, channels + 1, device=cuda_device)
            .view(-1, 1, 1) / channels, dye_alt[:1].repeat(channels, 1, 1), vel, sc, scheme, dt,
            dx)
    got = cuda_phases.mac_dye_phase_cuda(*args)
    torch.cuda.synchronize()
    _assert_bit_equal(got, cuda_phases.mac_dye_phase_plain(*args), f"mac_dye_c{channels}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_mac_dye_entry_refuses_wrong_operands(cuda_device, dtype):
    """The one storage-flag entry point refuses what the per-dtype pair
    did: another storage dtype, operands of mixed dtypes, shapes, devices or
    layouts, and an unknown scheme; nothing is launched."""
    dye, dye_alt, vel, sc, scheme, dt, dx = _mac_dye_call(2, 37, dtype, "kk", cuda_device)
    wrapper = cuda_phases.mac_dye_phase_cuda
    before = _runs(wrapper)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wrapper(dye.half(), dye_alt.half(), vel.half(), sc, scheme, dt, dx)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(TypeError, match="dtype"):
        wrapper(dye, dye_alt.to(other), vel, sc, scheme, dt, dx)
    with pytest.raises(TypeError, match="dtype"):
        wrapper(dye, dye_alt, vel.to(other), sc, scheme, dt, dx)
    with pytest.raises(ValueError, match="shape"):
        wrapper(dye, dye_alt, vel[:, :-1].contiguous(), sc, scheme, dt, dx)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(dye, dye_alt.transpose(1, 2).contiguous().transpose(1, 2), vel, sc, scheme, dt, dx)
    with pytest.raises(ValueError, match="on cpu"):
        wrapper(dye, dye_alt.cpu(), vel, sc, scheme, dt, dx)
    with pytest.raises(ValueError, match="scheme"):
        wrapper(dye, dye_alt, vel, sc, "cip", dt, dx)
    assert _runs(wrapper) == before


# The fused MAC velocity phase (B2: one launch a call; the pre-BC velocity
# on the tile + 3 or + 4, the BC'd on + 1 or + 2) on the MAC dye phase's
# grids; its open scene is fluid to the edge with every velocity BC code
# (ghost mirrors, inflow, outflow) on the first and last rows and columns.
def _mac_velocity_call(bc, res, dtype, scheme, device):
    """Seeded (v, p, v_alt, scene, scheme, re, dt, dx) of scene `bc` at
    `res` (None: the open scene) in `dtype`."""
    cfg = SimConfig.create(resolution=res, re=1000.0, dtype=str(dtype).removeprefix("torch."))
    sc = scene_for_dtype(get_scene(2 if bc is None else bc, res, device), cfg)
    gen = torch.Generator(device="cpu").manual_seed(40 * (bc or 7) + res)

    def rnd(lead, scale, offset=0.0):
        t = offset + scale * torch.randn((*lead, *sc.shape), generator=gen)
        return t.to(dtype).to(device)

    if bc is None:
        code = _edge_codes(sc.shape, 6, device)
        fluid = torch.ones(sc.shape, dtype=torch.bool, device=device)
        sc = sc._replace(vbc_code=code, vbc_targets=torch.stack([code == k for k in range(1, 5)]),
                         inflow=code == 5, outflow=code == 6, fluid=fluid,
                         fluid8=fluid.to(torch.int8), bc_const=rnd((2,), 1.0))
    return rnd((2,), 3.0), rnd((), 0.3), rnd((2,), 0.5), sc, scheme, cfg.re, cfg.dt, cfg.dx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scheme", ["upwind", "kk"])
@pytest.mark.parametrize("grid", MAC_DYE_GRIDS.values(), ids=MAC_DYE_GRIDS.keys())
def test_cuda_fused_mac_velocity_bit_equal_to_plain(cuda_device, grid, scheme, dtype):
    """One launch, two output allocations (no float scratch at bf16), both
    outputs equal to the plain version's to the bit."""
    args = _mac_velocity_call(*grid, dtype, scheme, cuda_device)
    wrapper = cuda_phases.mac_velocity_phase_cuda
    before, allocs = _runs(wrapper), _allocations(cuda_device)
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert _runs(wrapper) == before + 1
    assert _allocations(cuda_device) - allocs == 2
    _assert_bit_equal(got, cuda_phases.mac_velocity_phase_plain(*args), f"mac_velocity_{scheme}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_mac_velocity_entry_refuses_wrong_operands(cuda_device, dtype):
    """The one storage-flag entry point refuses what the two per-dtype ones
    refused: another storage dtype, operands of mixed dtypes, shapes,
    devices or layouts, and an unknown scheme; nothing is launched."""
    v, p, v_alt, sc, scheme, re, dt, dx = _mac_velocity_call(2, 37, dtype, "kk", cuda_device)
    wrapper = cuda_phases.mac_velocity_phase_cuda
    before = _runs(wrapper)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wrapper(v.half(), p.half(), v_alt.half(), sc, scheme, re, dt, dx)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(TypeError, match="dtype"):
        wrapper(v, p.to(other), v_alt, sc, scheme, re, dt, dx)
    with pytest.raises(TypeError, match="dtype"):
        wrapper(v, p, v_alt.to(other), sc, scheme, re, dt, dx)
    with pytest.raises(ValueError, match="shape"):
        wrapper(v, p[:, :-1].contiguous(), v_alt, sc, scheme, re, dt, dx)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(v, p, v_alt.transpose(1, 2).contiguous().transpose(1, 2), sc, scheme, re, dt, dx)
    with pytest.raises(ValueError, match="on cpu"):
        wrapper(v, p.cpu(), v_alt, sc, scheme, re, dt, dx)
    with pytest.raises(ValueError, match="scheme"):
        wrapper(v, p, v_alt, sc, "cip", re, dt, dx)
    assert _runs(wrapper) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 5, 16, 40])
@pytest.mark.parametrize("mode", cuda_dtype_probes.COPY_MODES)
def test_cuda_row_copy_bit_equal_at_each_window(cuda_device, mode, t, dtype):
    """Every copy at several window heights (the tail copy one block a row)
    bit-equal to its plain slices, on seeded normal values; the head copy,
    which moves rows [8, 24) of its window, refuses a window of fewer than
    24 rows, where its plain slices do not fit either."""
    x = torch.randn((t + 16, 128), generator=torch.Generator().manual_seed(t)).to(dtype)
    before = _runs(cuda_dtype_probes.row_copy_cuda)
    if mode == "head" and t < 8:
        with pytest.raises(ValueError, match="window"):
            cuda_dtype_probes.row_copy_cuda(x.to(cuda_device), mode, t)
        with pytest.raises(RuntimeError):
            cuda_dtype_probes.row_copy_plain(x, mode, t)
        assert _runs(cuda_dtype_probes.row_copy_cuda) == before
        return
    got = cuda_dtype_probes.row_copy_cuda(x.to(cuda_device), mode, t)
    torch.cuda.synchronize()
    assert _runs(cuda_dtype_probes.row_copy_cuda) == before + 1
    assert torch.equal(got.cpu(), cuda_dtype_probes.row_copy_plain(x, mode, t))


# --- the front end on the card --------------------------------------------

FRONT_WRAPPERS = (cuda_phases.cip_velocity_phase_cuda, cuda_phases.confinement_cuda,
                  cuda_stencil.sor_iteration_cuda, cuda_phases.cip_dye_phase_cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_render_matches_cpu_render(cuda_device, dtype):
    """The four views of a kernel-path state, rendered on the card, within
    1e-6 of the same state rendered on the CPU."""
    from fluid2d_tpu_torch import FluidSimulator
    from fluid2d_tpu_torch.convert import state_from_numpy, state_to_numpy
    from fluid2d_tpu_torch.utils.viz import render_rgb

    sim = FluidSimulator.create(2, RES, dtype=dtype)
    assert sim.device.type == "cuda"
    sim.step(12)
    cpu_state = state_from_numpy(state_to_numpy(sim.state), "cpu", dtype)
    cpu_scene = scene_for_dtype(get_scene(2, RES, "cpu"), sim.cfg)
    for vis in range(4):
        got = sim.render(vis)
        assert got.device.type == "cuda" and got.dtype == torch.float32
        ref = render_rgb(cpu_state, cpu_scene, sim.cfg, vis)
        assert float(ref.abs().max()) > 0
        assert float((got.cpu() - ref).abs().max()) <= 1e-6, vis


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_checkpoint_round_trip_is_bit_exact(cuda_device, dtype, tmp_path):
    """A kernel-path state through a checkpoint onto the card, bit for bit;
    7 + 5 steps through it equal 12 straight steps on every leaf."""
    from fluid2d_tpu_torch import FluidSimulator, SimState

    a = FluidSimulator.create(2, RES, dtype=dtype)
    a.step(7)
    a.save(tmp_path / "a.npz")
    b = FluidSimulator.load(tmp_path / "a.npz")
    assert b.device.type == "cuda" and b.step_count == 7
    for name, x, y in zip(SimState._fields, a.state, b.state):
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name
    b.step(5)
    c = FluidSimulator.create(2, RES, dtype=dtype)
    c.step(12)
    for name, x, y in zip(SimState._fields, b.state, c.state):
        if x is not None:
            assert torch.equal(x, y), name


@pytest.mark.cuda
def test_cuda_cli_default_device_launches_the_kernels(cuda_device, tmp_path, capsys):
    """``cli.main`` at res=400 with no --device runs on the card: each of the
    main path's four kernels once a step."""
    from fluid2d_tpu_torch import cli

    before = [_runs(w) for w in FRONT_WRAPPERS]
    cli.main(["-bc", "2", "-res", "400", "--steps", "5", "--log-every", "5", "--dump-fields",
              "--output", str(tmp_path)])
    assert [_runs(w) - n for w, n in zip(FRONT_WRAPPERS, before)] == [5, 5, 5, 5]
    out = capsys.readouterr().out
    assert "step 5:" in out and "div_rms=" in out and "NaN" not in out
    with np.load(tmp_path / "step_000005.npz") as data:
        assert data["v"].shape == (800, 400, 2) and np.isfinite(data["v"]).all()


@pytest.mark.cuda
def test_cuda_launch_counter_counts_each_enqueued_entry_point(cuda_device):
    """``launch`` adds one to its entry point's count a call, and nothing
    elsewhere; a call the wrapper refuses (a float64 operand) counts
    nothing; ``add_launches`` adds counts × times."""
    x = torch.rand(4096, device=cuda_device)
    before = dict(launches)
    cuda_probes.copy_add1_cuda(x)
    cuda_probes.copy_add1_cuda(x)
    torch.cuda.synchronize()
    want = {**before, "f2d_copy_add1": before.get("f2d_copy_add1", 0) + 2}
    assert dict(launches) == want
    with pytest.raises(TypeError):
        cuda_probes.copy_add1_cuda(x.double())
    assert dict(launches) == want
    trace.add_launches({"f2d_copy_add1": 2, "f2d_sor_iteration": 1}, times=3)
    assert launches["f2d_copy_add1"] == want["f2d_copy_add1"] + 6
    assert launches["f2d_sor_iteration"] == want.get("f2d_sor_iteration", 0) + 3
    trace.add_launches({"f2d_copy_add1": 2, "f2d_sor_iteration": 1}, times=-3)
    assert {k: n for k, n in launches.items() if n} == {k: n for k, n in want.items() if n}


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["cip", "upwind", "kk"])
def test_cuda_step_launches_once_a_phase_inside_its_spans(cuda_device, scheme):
    """A kernel-path step of the eager loop under the profiler with spans
    on: each phase span holds one ``f2d.launch``, each step four phases and
    four launches, and the counter moves by four a step; KK's MAC phases
    open their ``.kk`` spans and move their ``.kk`` keys. On the graph path
    (``FluidSimulator.step``) the same steps open one ``f2d.graph_replay``
    a replay and none of those spans, and the counter moves as much."""
    from fluid2d_tpu_torch import FluidSimulator

    sim = FluidSimulator.create(2, RES, scheme=scheme)
    sim.step(2)
    torch.cuda.synchronize()
    run = make_run_fn(sim.cfg)
    before = sum(launches.values())
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof, trace.enabled(True):
        run(_clone(sim.state), sim.scene, 3)
    torch.cuda.synchronize()
    assert sum(launches.values()) == before + 12
    names = [e.name for e in prof.events() if e.name.startswith("f2d.")]
    assert names.count("f2d.step") == 3 and names.count("f2d.launch") == 12
    assert sum(n.startswith("f2d.phase.") for n in names) == 12
    if scheme == "kk":
        assert names.count("f2d.phase.mac_velocity.kk") == names.count("f2d.phase.mac_dye.kk") == 3
        assert launches["f2d_mac_velocity_phase.kk"] >= 3 and launches["f2d_mac_dye_phase.kk"] >= 3
    before, replays = sum(launches.values()), sum(trace.graph_replays.values())
    with torch.profiler.profile(activities=acts) as prof, trace.enabled(True):
        sim.step(3)
    torch.cuda.synchronize()
    assert sum(launches.values()) == before + 12
    names = [e.name for e in prof.events() if e.name.startswith("f2d.")]
    assert names.count("f2d.graph_replay") == sum(trace.graph_replays.values()) - replays > 0
    assert set(names) == {"f2d.graph_replay"}


@pytest.mark.cuda
def test_cuda_to_image_counts_the_frames_bytes(cuda_device):
    """``to_image`` of a CUDA frame adds X·Y·3 bytes to ``d2h_bytes``, the
    uint8 image it copies; the field getters and the field dump add what
    they copy."""
    from fluid2d_tpu_torch import FluidSimulator
    from fluid2d_tpu_torch.utils.viz import to_image

    sim = FluidSimulator.create(2, RES)
    x_rows, y_cols = sim.scene.shape
    n = trace.d2h_bytes
    img = to_image(sim.render(0))
    assert img.shape == (y_cols, x_rows, 3)
    assert trace.d2h_bytes == n + x_rows * y_cols * 3
    n = trace.d2h_bytes
    sim.get_dye_field()
    assert trace.d2h_bytes == n + x_rows * y_cols * 3 * 4
    n = trace.d2h_bytes
    sim.field_to_numpy()
    assert trace.d2h_bytes == n + x_rows * y_cols * (2 + 1 + 3) * 4


# --- V1: the view's 8-bit image ---------------------------------------------------


def _numpy_image(rgb: torch.Tensor) -> np.ndarray:
    """The NumPy path of ``to_image`` on the frame's host copy."""
    from fluid2d_tpu_torch.utils.viz import to_image

    with np.errstate(invalid="ignore"):  # NumPy's cast of NaN warns (and gives 0)
        return to_image(rgb.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize(("bc", "res", "scheme"), [(2, 1600, "cip"), (1, 400, "upwind")],
                         ids=["3200x1600", "800x400"])
def test_cuda_to_image_bit_equal_on_the_four_views(cuda_device, bc, res, scheme):
    """The four views of a stepped state at the benchmark's two grids: the
    card's image (V1, one launch a call) bit-equal to the NumPy path's."""
    from fluid2d_tpu_torch import FluidSimulator
    from fluid2d_tpu_torch.utils.viz import to_image

    sim = FluidSimulator.create(bc, res, scheme=scheme)
    sim.step(6)
    for vis in range(4):
        rgb = sim.render(vis)
        n = launches["f2d_to_image"]
        got = to_image(rgb)
        assert launches["f2d_to_image"] == n + 1
        assert got.dtype == np.uint8 and got.shape == (rgb.shape[1], rgb.shape[0], 3)
        np.testing.assert_array_equal(got, _numpy_image(rgb), err_msg=f"view {vis}")


def _view_frames(dev):
    """(name, frame) on the card: random frames in [-0.2, 1.2] at the
    benchmark's grids and ragged shapes, NaN and ±inf in some cells; the
    edge values; a frame at offset 1 of a larger one (not 16-byte aligned:
    the kernel's masked path on whole tiles)."""
    from test_torch_view import SHAPES, edge_frame

    gen = torch.Generator(device="cpu").manual_seed(15)
    frames = []
    for shape in [(3200, 1600), (800, 400), *SHAPES]:
        f = torch.rand((*shape, 3), generator=gen) * 1.4 - 0.2
        f.view(-1)[::97] = float("nan")
        f.view(-1)[5::211] = float("inf")
        f.view(-1)[7::223] = -float("inf")
        frames.append((f"{shape[0]}x{shape[1]}", f.to(dev)))
    frames.append(("edge", torch.from_numpy(edge_frame()).to(dev)))
    big = torch.rand((128 * 128 * 3 + 1,), generator=gen).to(dev) * 1.4 - 0.2
    frames.append(("128x128_offset", big[1:].view(128, 128, 3)))
    return frames


@pytest.mark.cuda
def test_cuda_to_image_kernel_bit_equal_to_numpy(cuda_device):
    from fluid2d_tpu_torch.ops.cuda_view import to_image_cuda, to_image_plain

    for name, frame in _view_frames(cuda_device):
        n = launches["f2d_to_image"]
        got = to_image_cuda(frame)
        assert launches["f2d_to_image"] == n + 1
        assert got.device == cuda_device and got.dtype == torch.uint8 and got.is_contiguous()
        ref = _numpy_image(frame)
        np.testing.assert_array_equal(got.cpu().numpy(), ref, err_msg=name)
        np.testing.assert_array_equal(to_image_plain(frame.cpu()).numpy(), ref, err_msg=name)


@pytest.mark.cuda
def test_cuda_to_image_arrays_are_the_callers(cuda_device):
    """A later call, of the same shape or another, leaves every array
    returned earlier as it was: each is a fresh array of the caller's."""
    from fluid2d_tpu_torch.utils.viz import to_image

    gen = torch.Generator(device="cpu").manual_seed(16)
    frames = [torch.rand((96, 64, 3), generator=gen).to(cuda_device) for _ in range(3)]
    first = to_image(frames[0])
    kept = first.copy()
    second = to_image(frames[1])
    to_image(torch.rand((40, 24, 3), generator=gen).to(cuda_device))
    third = to_image(frames[2])
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(second, _numpy_image(frames[1]))
    np.testing.assert_array_equal(third, _numpy_image(frames[2]))
    assert not np.shares_memory(first, second) and not np.shares_memory(second, third)
    assert first.flags.writeable
