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

The standalone CIP advection (C1) bit-equal at float32 and bf16; the FMA
sweep (C5d) within ``fma_rate_error_bound`` of the float64 plain version,
which one round short exceeds; the geometry twin (C5e/f) within
1e-5·max(1, |ref|max); the row window (C5g) and the el-op toys (C6)
bit-equal.
"""

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch import SimConfig, get_scene, init_state, make_run_fn, scene_for_dtype
from fluid2d_tpu_torch.ops import cuda_dtype_probes, cuda_phases, cuda_probes, cuda_stencil
from fluid2d_tpu_torch.utils import profiling

torch.set_num_threads(1)

RES = 64  # scene 2 on a (128, 64) grid: whole 32×8 thread blocks
RAGGED_RES = 37  # (74, 37): neither axis a multiple of the block


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


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
    ]


KERNEL_IDS = ["sor", "sor_v_limit", "confinement", "cip_velocity", "cip_dye",
              "jacobi1", "jacobi2_v_limit", "jacobi4", "jacobi4_v_limit",
              "mac_velocity_upwind", "mac_velocity_kk", "mac_dye_upwind", "mac_dye_kk"]


@pytest.mark.cuda
@pytest.mark.parametrize("res", [RES, RAGGED_RES])
@pytest.mark.parametrize("which", range(len(KERNEL_IDS)), ids=KERNEL_IDS)
def test_cuda_kernel_matches_plain(cuda_device, which, res):
    wrapper, plain, args, kwargs = _kernel_calls(res, cuda_device)[which]
    before = wrapper.launches
    got = wrapper(*args, **kwargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
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
              for kernel in ("sor", *(f"jacobi{n}" for n in range(1, 5))))]


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
    before = wrapper.launches
    got = wrapper(*args, **kwargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_bit_equal(got, plain(*args, **kwargs), BF16_IDS[which])


@pytest.mark.cuda
@pytest.mark.parametrize("config", [{}, {"scheme": "upwind"}, {"scheme": "kk"},
                                    {"pressure_solver": "jacobi", "n_pressure_iter": 6}],
                         ids=["cip", "upwind", "kk", "cip_jacobi6"])
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", cuda_dtype_probes.RATE_MODES)
def test_cuda_dtype_rate_matches_plain(cuda_device, mode, dtype):
    from fluid2d_tpu_torch.scripts.vpu_dtype_probe import check_dtype_rate

    before = cuda_dtype_probes.dtype_rate_cuda.launches
    res = check_dtype_rate(mode, dtype, cuda_device, rows=64, cols=256, passes=3072)
    assert cuda_dtype_probes.dtype_rate_cuda.launches == before + 2
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
    before = (cuda_probes.mix_twin_cuda.launches, cuda_probes.mix_twin_bf16_cuda.launches)
    got = cuda_probes.mix_twin_cuda(ops)
    torch.cuda.synchronize()
    assert (cuda_probes.mix_twin_cuda.launches,
            cuda_probes.mix_twin_bf16_cuda.launches) == (before[0], before[1] + 1)
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
], ids=["cip", "upwind", "kk", "cip_jacobi", "kk_jacobi6"])
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


# --- the roofline's probes (C2-C4) ----------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4 * 1000, 4 * 1000 + 3, 1, 2])
def test_cuda_copy_add1_is_bit_equal(cuda_device, n):
    """C2 over whole float4s and a ragged tail: bit-equal to x + 1."""
    gen = torch.Generator(device="cpu").manual_seed(n)
    x = torch.randn(n, generator=gen).to(cuda_device)
    before = cuda_probes.copy_add1_cuda.launches
    got = cuda_probes.copy_add1_cuda(x)
    out = torch.empty_like(x)
    into = cuda_probes.copy_add1_cuda(x, out=out)
    torch.cuda.synchronize()
    assert cuda_probes.copy_add1_cuda.launches == before + 2
    assert into is out
    assert torch.equal(got, x + 1) and torch.equal(out, x + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["cip_dye_phase", "sor_iteration_v_limit"])
def test_cuda_mix_twin_matches_plain(cuda_device, mix):
    """C3 on two registered mixes at a ragged grid: within 1e-5 of the
    plain sum (the same additions in the same order)."""
    ops = profiling.twin_operands(mix, 2 * RAGGED_RES, RAGGED_RES, cuda_device)
    before = (cuda_probes.mix_twin_cuda.launches, cuda_probes.mix_twin_bf16_cuda.launches)
    got = cuda_probes.mix_twin_cuda(ops)
    torch.cuda.synchronize()
    assert (cuda_probes.mix_twin_cuda.launches,
            cuda_probes.mix_twin_bf16_cuda.launches) == (before[0] + 1, before[1])
    assert len(got) == sum(profiling._KERNEL_MIXES[mix]["f_out"])
    _assert_close(got, cuda_probes.mix_twin_plain(ops), mix, 1e-5)


@pytest.mark.cuda
def test_cuda_fma_rate_matches_plain_at_shallow_depth(cuda_device):
    """C4 at 64 passes: one rounding per FMA against the plain version's
    two, within 1e-5·max(1, |ref|max)."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    x = torch.rand((256, 1024), generator=gen).to(cuda_device)
    before = cuda_probes.fma_rate_cuda.launches
    got = cuda_probes.fma_rate_cuda(x, 64)
    torch.cuda.synchronize()
    assert cuda_probes.fma_rate_cuda.launches == before + 1
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


def _advect_args(res: int, dtype: torch.dtype, self_advect: bool, device):
    """Seeded inputs of the standalone advection at scene 2's grid: the dye
    form (C = 3, a separate velocity) or the velocity form (C = 2, vel is f)."""
    sc = get_scene(2, res, device)
    gen = torch.Generator(device="cpu").manual_seed(res + 7)
    chans = 2 if self_advect else 3

    def rnd(lead, scale):
        return (scale * torch.randn((lead, *sc.shape), generator=gen)).to(dtype).to(device)

    f, fx, fy = rnd(chans, 8.0 if self_advect else 0.5), rnd(chans, 0.1), rnd(chans, 0.1)
    vel = f if self_advect else rnd(2, 8.0)
    alts = [rnd(chans, 0.5) for _ in range(3)]
    cfg = SimConfig.create(resolution=res)
    return (f, fx, fy, vel, *alts, sc.fluid8, cfg.dt, cfg.dx)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [RES, RAGGED_RES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("self_advect", [False, True], ids=["dye_form", "velocity_form"])
def test_cuda_cip_advect_matches_plain(cuda_device, self_advect, dtype, res):
    """C1 against its plain version: bit-equal at both dtypes (the phases'
    advection arithmetic, each output rounded once); an output aliasing an
    input raises before any launch."""
    from fluid2d_tpu_torch.ops.cuda_stencil import cip_advect_cuda, cip_advect_plain

    args = _advect_args(res, dtype, self_advect, cuda_device)
    before = cip_advect_cuda.launches
    got = cip_advect_cuda(*args)
    torch.cuda.synchronize()
    assert cip_advect_cuda.launches == before + 1
    _assert_bit_equal(got, cip_advect_plain(*args), "cip_advect")
    with pytest.raises(ValueError, match="aliases"):
        cip_advect_cuda(*args, out=(args[4], torch.empty_like(args[0]), torch.empty_like(args[0])))
    assert cip_advect_cuda.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [64, 1024])
@pytest.mark.parametrize("nchain", cuda_probes.FMA_SWEEP_CHAINS)
def test_cuda_fma_sweep_within_bound(cuda_device, nchain, threads):
    """C5d at the sweep's shallowest and deepest depth: within
    fma_rate_error_bound of the float64 plain version, one round short beyond it."""
    from fluid2d_tpu_torch.scripts.vpu_rate_sweep import check_chains

    x = torch.rand((64, 1024), generator=torch.Generator().manual_seed(nchain)).to(cuda_device)
    before = cuda_probes.fma_sweep_cuda.launches
    for depth in (64, 1024):
        res = check_chains(x, nchain, depth, threads)
        assert res["max_abs_err"] <= res["bound"] < res["one_round_short_min_err"]
    assert cuda_probes.fma_sweep_cuda.launches == before + 2


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
    before = cuda_probes.geometry_twin_cuda.launches
    got = cuda_probes.geometry_twin_cuda(ops)
    torch.cuda.synchronize()
    assert cuda_probes.geometry_twin_cuda.launches == before + 1
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
@pytest.mark.parametrize("shape", [(32, 128), (8, 128), (3200, 1600)])
@pytest.mark.parametrize("op", cuda_probes.TOY_OPS)
def test_cuda_toy_elementwise_bit_equal(cuda_device, op, shape):
    """C6: each toy bit-equal to its plain version on the card (the division
    as PyTorch's CUDA division by a Python scalar rounds it)."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    before = cuda_probes.toy_elementwise_cuda.launches
    got = cuda_probes.toy_elementwise_cuda(x, op)
    torch.cuda.synchronize()
    assert cuda_probes.toy_elementwise_cuda.launches == before + 1
    assert torch.equal(got, cuda_probes.toy_elementwise_plain(x, op))
