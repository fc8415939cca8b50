"""The port's four phase kernels: each plain PyTorch version against its
Pallas kernel (interpret mode, as tests/test_pallas.py runs them), and
the CPU dispatch of the wrappers. The CUDA kernels themselves are tested
against their plain versions in tests/test_torch_cuda.py.

Inputs are seeded NumPy arrays handed to both packages. Tolerance: every
output, alternates included, within 1e-5·max(1, |ref|max) — the
tests/test_pallas.py contract, which absorbs the Pallas kernels'
reciprocal-for-divide rewrites.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fluid2d_tpu.config import SimConfig as JaxConfig
from fluid2d_tpu.ops.pallas_phases import (
    cip_dye_phase_pallas,
    cip_velocity_phase_pallas,
    confinement_pallas,
)
from fluid2d_tpu.ops.pallas_stencil import sor_iteration_pallas
from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
from fluid2d_tpu_torch.convert import scene_from_numpy
from fluid2d_tpu_torch.ops import cuda_phases, cuda_stencil

torch.set_num_threads(1)

RES = 16  # scene 2 on a (32, 16) grid
TOL = 1e-5
OMEGA = 1.3
RE = 1000.0
EPS = 5.0
CFG = JaxConfig.create(resolution=RES)
DT, DX = CFG.dt, CFG.dx
SHAPE = (2 * RES, RES)

JAX_SCENE = jax_get_scene(2, RES)
SCENE_NP = {k: np.asarray(v) for k, v in zip(JAX_SCENE._fields, JAX_SCENE)}


def _fields(seed: int, **shapes_scales):
    """Seeded float32 arrays: name → (leading shape, scale)."""
    rng = np.random.default_rng(seed)
    return {
        name: (scale * rng.standard_normal((*lead, *SHAPE))).astype(np.float32)
        for name, (lead, scale) in shapes_scales.items()
    }


def _assert_close(got, ref, names, tol=TOL):
    assert len(got) == len(ref) == len(names)
    for name, g, r in zip(names, got, ref):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = r.detach().cpu().numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
        assert g.shape == r.shape, f"{name}: shape {g.shape} != {r.shape}"
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=tol * scale, rtol=0, err_msg=name)


def _t(arrays, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in arrays.items()}


def _sor_inputs(seed=1):
    # u, w ~ N(0, 8²): many cells exceed the limit of 10, so the limiter bites.
    return _fields(seed, p=((), 0.3), pa=((), 0.3), u=((), 8.0), w=((), 8.0))


def _vel_inputs(seed=2):
    return _fields(seed, v=((2,), 0.5), va=((2,), 0.5), vx=((2,), 0.1),
                   vxa=((2,), 0.1), vy=((2,), 0.1), vya=((2,), 0.1), p=((), 0.3))


def _dye_inputs(seed=3):
    f = _fields(seed, dye=((3,), 0.5), da=((3,), 0.5), dxg=((3,), 0.1),
                dxa=((3,), 0.1), dyg=((3,), 0.1), dya=((3,), 0.1), vel=((2,), 0.5))
    f["dye"] += 0.5  # straddle the [0, 1] clamp
    return f


# --- plain versions against the Pallas kernels (interpret mode) ------------


@pytest.mark.parametrize("v_limit", [None, 10.0])
def test_sor_plain_matches_pallas(v_limit):
    a = _sor_inputs()
    ref = sor_iteration_pallas(
        *(jnp.asarray(a[k]) for k in ("p", "pa", "u", "w")),
        JAX_SCENE.pbc_code, JAX_SCENE.fluid8, OMEGA, DT, DX,
        v_limit=v_limit, tile_x=8, interpret=True,
    )
    t = _t(a)
    sc = scene_from_numpy(SCENE_NP, "cpu")
    got = cuda_stencil.sor_iteration_plain(
        t["p"], t["pa"], t["u"], t["w"], sc.pbc_code, sc.fluid8, OMEGA, DT, DX, v_limit=v_limit
    )
    names = ("p_cur", "p_alt") + (() if v_limit is None else ("v_lim",))
    _assert_close(got, ref, names)
    if v_limit is not None:
        norm = np.sqrt(a["u"] ** 2 + a["w"] ** 2)
        assert (norm > v_limit).any() and (norm <= v_limit).any()


def test_confinement_plain_matches_pallas():
    a = _fields(4, v=((2,), 0.5), va=((2,), 0.5))
    ref = confinement_pallas(jnp.asarray(a["v"]), jnp.asarray(a["va"]), JAX_SCENE.fluid8,
                             DT, EPS, DX, tile_x=8, interpret=True)
    t = _t(a)
    sc = scene_from_numpy(SCENE_NP, "cpu")
    got = cuda_phases.confinement_plain(t["v"], t["va"], sc.fluid8, DT, EPS, DX)
    _assert_close(got, ref, ("v_cur", "v_alt"))
    assert got[1] is t["v"], "the new alternate is the input, passed through"


def test_cip_velocity_phase_plain_matches_pallas():
    a = _vel_inputs()
    keys = ("v", "p", "va", "vx", "vxa", "vy", "vya")
    ref = cip_velocity_phase_pallas(*(jnp.asarray(a[k]) for k in keys), JAX_SCENE,
                                    RE, DT, DX, tile_x=8, interpret=True)
    t = _t(a)
    sc = scene_from_numpy(SCENE_NP, "cpu")
    got = cuda_phases.cip_velocity_phase_plain(*(t[k] for k in keys), sc, RE, DT, DX)
    _assert_close(got, ref, ("v", "vx", "vy", "v_na", "vx_na", "vy_na"))


def test_cip_dye_phase_plain_matches_pallas():
    a = _dye_inputs()
    keys = ("dye", "da", "dxg", "dxa", "dyg", "dya", "vel")
    ref = cip_dye_phase_pallas(*(jnp.asarray(a[k]) for k in keys), JAX_SCENE,
                               RE, DT, DX, tile_x=8, interpret=True)
    t = _t(a)
    sc = scene_from_numpy(SCENE_NP, "cpu")
    got = cuda_phases.cip_dye_phase_plain(*(t[k] for k in keys), sc, RE, DT, DX)
    _assert_close(got, ref, ("dye", "dyex", "dyey", "d_na", "dx_na", "dy_na"))
    d = got[0].numpy()
    assert d.min() >= 0.0 and d.max() <= 1.0


# --- wrapper dispatch on CPU tensors ------------------------------------------


def _wrapper_calls():
    """(wrapper, plain version, args, kwargs) for each kernel, CPU tensors."""
    sc = scene_from_numpy(SCENE_NP, "cpu")
    s, v, d = _t(_sor_inputs()), _t(_vel_inputs()), _t(_dye_inputs())
    sor_args = (s["p"], s["pa"], s["u"], s["w"], sc.pbc_code, sc.fluid8, OMEGA, DT, DX)
    return [
        (cuda_stencil.sor_iteration_cuda, cuda_stencil.sor_iteration_plain, sor_args, {}),
        (cuda_stencil.sor_iteration_cuda, cuda_stencil.sor_iteration_plain, sor_args,
         {"v_limit": 10.0}),
        (cuda_phases.confinement_cuda, cuda_phases.confinement_plain,
         (v["v"], v["va"], sc.fluid8, DT, EPS, DX), {}),
        (cuda_phases.cip_velocity_phase_cuda, cuda_phases.cip_velocity_phase_plain,
         (*(v[k] for k in ("v", "p", "va", "vx", "vxa", "vy", "vya")), sc, RE, DT, DX), {}),
        (cuda_phases.cip_dye_phase_cuda, cuda_phases.cip_dye_phase_plain,
         (*(d[k] for k in ("dye", "da", "dxg", "dxa", "dyg", "dya", "vel")), sc, RE, DT, DX), {}),
    ]


def test_wrappers_on_cpu_take_the_plain_version_and_count_nothing(monkeypatch):
    calls = _wrapper_calls()
    for wrapper, _, _, _ in calls:
        monkeypatch.setattr(wrapper, "launches", 0)
    for wrapper, plain, args, kwargs in calls:
        got, ref = wrapper(*args, **kwargs), plain(*args, **kwargs)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), wrapper.__name__
    for wrapper, _, _, _ in calls:
        assert wrapper.launches == 0, wrapper.__name__


def test_wrapper_refuses_a_non_cpu_non_cuda_device():
    meta = torch.empty((2, *SHAPE), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_phases.confinement_cuda(meta, meta, meta, DT, EPS, DX)
