"""The port's MAC schemes (upwind, Kawamura-Kuwahara) and Jacobi solver
against the JAX package, on the CPU:

* the eager advection functions and the Jacobi iteration against their JAX
  twins (1e-5·max(1, |ref|max), the same float32 algebra in another
  library);
* the plain versions of the three kernels (MAC velocity phase, MAC dye
  phase, fused Jacobi iterations) against the Pallas kernels in interpret
  mode, as tests/test_pallas.py runs them (1e-5·max(1, |ref|max), which
  absorbs the Pallas kernels' 1/dx factored out of the sums);
* whole runs of the MAC and Jacobi configurations against the JAX
  package's ``make_run_fn`` with ``kernels="xla"`` (4 steps) and
  ``"pallas_interpret"`` (2 steps), every state leaf within
  2e-5·max(1, |ref|max), the ROADMAP's multi-step tolerance.

Inputs are seeded NumPy arrays handed to both packages.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fluid2d_tpu.config import SimConfig as JaxConfig
from fluid2d_tpu.models.simulator import make_run_fn as jax_make_run_fn
from fluid2d_tpu.ops import advection as jadv
from fluid2d_tpu.ops import pressure as jpres
from fluid2d_tpu.ops.pallas_phases import mac_dye_phase_pallas, mac_velocity_phase_pallas
from fluid2d_tpu.ops.pallas_stencil import jacobi_iteration_pallas
from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
from fluid2d_tpu.state import init_state as jax_init_state
import fluid2d_tpu_torch as ft
from fluid2d_tpu_torch.convert import scene_from_numpy, state_from_numpy, state_to_numpy
from fluid2d_tpu_torch.ops import advection as tadv
from fluid2d_tpu_torch.ops import cuda_phases, cuda_stencil
from fluid2d_tpu_torch.ops import pressure as tpres

torch.set_num_threads(1)

KERNEL_RES = 16  # scene 2 on a (32, 16) grid
RUN_RES = 32  # scene 2 on a (64, 32) grid
OP_TOL = 1e-5
STEP_TOL = 2e-5
RE = 1000.0
DT, DX = 0.05 / KERNEL_RES, 1.0 / KERNEL_RES
SHAPE = (2 * KERNEL_RES, KERNEL_RES)


def _scene_pair(bc: int, res: int):
    jax_scene = jax_get_scene(bc, res)
    arrays = {k: np.asarray(v) for k, v in zip(jax_scene._fields, jax_scene)}
    return jax_scene, scene_from_numpy(arrays, "cpu")


JAX_SCENE, T_SCENE = _scene_pair(2, KERNEL_RES)


def _rand(seed, lead=(), scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (offset + scale * rng.standard_normal((*lead, *SHAPE))).astype(np.float32)


def _to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, ref, names, tol):
    assert len(got) == len(ref) == len(names)
    for name, g, r in zip(names, got, ref):
        g, r = _to_np(g), _to_np(r)
        assert g.shape == r.shape and g.dtype == r.dtype, name
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=tol * scale, rtol=0, err_msg=name)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy())


# --- eager ops against their JAX twins ------------------------------------------


@pytest.mark.parametrize("name", ["advect_central", "advect_upwind", "advect_kk"])
@pytest.mark.parametrize("chans", [2, 3])
def test_advection_matches_jax(name, chans):
    u, w = _rand(30, scale=0.5), _rand(31, scale=0.5)
    u[::3, ::2] = 0.0  # zero velocity takes the u >= 0 branch
    w[1::4, ::3] = np.nan  # NaN compares false: the u >= 0 branch too
    phi = _rand(32, (chans,))
    ref = np.asarray(getattr(jadv, name)(jnp.asarray(u), jnp.asarray(w), jnp.asarray(phi), DX))
    got = getattr(tadv, name)(_t(u), _t(w), _t(phi), DX).numpy()
    assert got.shape == ref.shape == (chans, *SHAPE)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    finite = np.isfinite(ref)
    scale = max(1.0, float(np.abs(ref[finite]).max()))
    np.testing.assert_allclose(got[finite], ref[finite], atol=OP_TOL * scale, rtol=0)


def test_jacobi_pressure_iteration_matches_jax():
    p, pa, u, w = (_rand(s) for s in (33, 34, 35, 36))
    ref = jpres.jacobi_pressure_iteration(*(jnp.asarray(a) for a in (p, pa, u, w)),
                                          JAX_SCENE, DT, DX)
    got = tpres.jacobi_pressure_iteration(*(_t(a) for a in (p, pa, u, w)), T_SCENE, DT, DX)
    _assert_close(got, ref, ("p_cur", "p_alt"), OP_TOL)


# --- plain versions against the Pallas kernels (interpret mode) --------------------


@pytest.mark.parametrize("scheme", ["upwind", "kk"])
def test_mac_velocity_phase_plain_matches_pallas(scheme):
    v, va, p = _rand(40, (2,), 0.5), _rand(41, (2,), 0.5), _rand(42, (), 0.3)
    v[0, ::5, ::3] = -np.abs(v[0, ::5, ::3])  # both upwind directions in both axes
    ref = mac_velocity_phase_pallas(jnp.asarray(v), jnp.asarray(p), jnp.asarray(va), JAX_SCENE,
                                    scheme, RE, DT, DX, tile_x=8, interpret=True)
    got = cuda_phases.mac_velocity_phase_plain(_t(v), _t(p), _t(va), T_SCENE, scheme, RE, DT, DX)
    _assert_close(got, ref, ("v_cur", "v_alt"), OP_TOL)


@pytest.mark.parametrize("scheme", ["upwind", "kk"])
def test_mac_dye_phase_plain_matches_pallas(scheme):
    dye, da, vel = _rand(43, (3,), 0.5, 0.5), _rand(44, (3,), 0.5, 0.5), _rand(45, (2,), 0.5)
    ref = mac_dye_phase_pallas(jnp.asarray(dye), jnp.asarray(da), jnp.asarray(vel), JAX_SCENE,
                               scheme, DT, DX, tile_x=8, interpret=True)
    got = cuda_phases.mac_dye_phase_plain(_t(dye), _t(da), _t(vel), T_SCENE, scheme, DT, DX)
    _assert_close(got, ref, ("dye_cur", "dye_alt"), OP_TOL)
    d = got[0].numpy()
    assert d.min() >= 0.0 and d.max() <= 1.0
    assert got[1].numpy().max() > 1.0, "the alternate is the unclamped BC'd dye"


@pytest.mark.parametrize("v_limit", [None, 10.0])
@pytest.mark.parametrize("n_iters", [1, 2, 4])
def test_jacobi_plain_matches_pallas(n_iters, v_limit):
    p, pa = _rand(46, (), 0.3), _rand(47, (), 0.3)
    u, w = _rand(48, (), 8.0), _rand(49, (), 8.0)  # |v| straddles the limit
    ref = jacobi_iteration_pallas(*(jnp.asarray(a) for a in (p, pa, u, w)),
                                  JAX_SCENE.pbc_code, JAX_SCENE.not_wall8, DT, DX,
                                  n_iters=n_iters, v_limit=v_limit, tile_x=8, interpret=True)
    got = cuda_stencil.jacobi_iteration_plain(
        _t(p), _t(pa), _t(u), _t(w), T_SCENE.pbc_code, T_SCENE.not_wall8, DT, DX,
        n_iters=n_iters, v_limit=v_limit,
    )
    names = ("p_cur", "p_alt") + (() if v_limit is None else ("v_lim",))
    _assert_close(got, ref, names, OP_TOL)


def test_jacobi_refuses_more_than_four_iterations():
    p = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="1..4 iterations"):
        cuda_stencil.jacobi_iteration_cuda(p, p, p, p, T_SCENE.pbc_code, T_SCENE.not_wall8,
                                           DT, DX, n_iters=5)


def test_mac_phases_refuse_the_cip_scheme():
    v = torch.zeros((2, *SHAPE))
    with pytest.raises(ValueError, match="'upwind' or 'kk'"):
        cuda_phases.mac_velocity_phase_cuda(v, v[0], v, T_SCENE, "cip", RE, DT, DX)


# --- whole runs against the JAX package -------------------------------------------

# name → (scene, SimConfig.create keywords shared by both packages)
RUNS = {
    "upwind": (2, {"scheme": "upwind"}),
    "kk": (2, {"scheme": "kk"}),
    "cip_jacobi": (2, {"pressure_solver": "jacobi"}),
    "kk_jacobi6": (2, {"scheme": "kk", "pressure_solver": "jacobi", "n_pressure_iter": 6}),
    # bench.py preset 1's kind of run: no dye, no confinement, Re=1000.
    "upwind_preset1": (1, {"scheme": "upwind", "re": 1000.0, "dt": 5e-4, "vor_eps": None,
                           "enable_dye": False}),
}


def _seeded_state(jax_scene, cfg):
    """__graft_entry__.py's smooth seeded state (fluid cells only)."""
    st = jax_init_state(jax_scene, cfg)
    x_rows, y_cols = st.p.shape
    fluid = (np.asarray(jax_scene.mask) == 0).astype(np.float32)
    gx = np.linspace(0, 2 * np.pi, x_rows, dtype=np.float32)[:, None]
    gy = np.linspace(0, 2 * np.pi, y_cols, dtype=np.float32)[None, :]
    kw = {
        "v": jnp.asarray(np.stack([0.3 * np.sin(gx) * np.cos(2 * gy) * fluid,
                                   0.2 * np.cos(2 * gx) * np.sin(gy) * fluid])),
        "p": jnp.asarray(0.1 * np.sin(gx + gy) * fluid),
    }
    if cfg.enable_dye:
        kw["dye"] = jnp.asarray(np.stack([0.5 + 0.4 * np.sin(k * gx) * np.cos(gy) * fluid
                                          for k in (1, 2, 3)]))
    return st._replace(**kw)


def _np_state(state) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in zip(state._fields, state) if v is not None}


def _leaf_count(cfg) -> int:
    """step + the v and p pairs, + the CIP gradient pairs (vx, vy), + the
    dye pair (+ its CIP gradient pairs): 7 for MAC with dye, 15 for CIP."""
    cip = cfg.scheme == "cip"
    return 5 + (4 if cip else 0) + ((2 + (4 if cip else 0)) if cfg.enable_dye else 0)


@pytest.mark.parametrize(("jax_kernels", "n_steps"), [("xla", 4), ("pallas_interpret", 2)])
@pytest.mark.parametrize("run", list(RUNS))
def test_port_run_matches_jax(run, jax_kernels, n_steps):
    bc, kw = RUNS[run]
    jax_scene, t_scene = _scene_pair(bc, RUN_RES)
    jcfg = JaxConfig.create(resolution=RUN_RES, kernels=jax_kernels, **kw)
    start = _np_state(_seeded_state(jax_scene, jcfg))
    ref = _np_state(jax_make_run_fn(jcfg)(_seeded_state(jax_scene, jcfg), jax_scene, n_steps))
    assert np.abs(ref["v"]).max() > 1e-3 and int(ref["step"]) == n_steps

    cfg = ft.SimConfig.create(resolution=RUN_RES, **kw)
    got = state_to_numpy(ft.make_run_fn(cfg)(state_from_numpy(start, "cpu"), t_scene, n_steps))
    assert set(got) == set(ref) and len(ref) == _leaf_count(cfg)
    names = sorted(ref)
    _assert_close([got[n] for n in names], [ref[n] for n in names], names, STEP_TOL)


@pytest.mark.parametrize("scheme", ["upwind", "kk"])
def test_init_state_matches_jax_for_mac(scheme):
    jax_scene, t_scene = _scene_pair(2, KERNEL_RES)
    ref = _np_state(jax_init_state(jax_scene, JaxConfig.create(resolution=KERNEL_RES,
                                                               scheme=scheme)))
    got = state_to_numpy(ft.init_state(t_scene, ft.SimConfig.create(resolution=KERNEL_RES,
                                                                    scheme=scheme), "cpu"))
    assert set(got) == set(ref) == {"step", "v", "v_alt", "p", "p_alt", "dye", "dye_alt"}
    for name, a in ref.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


# kk800's settings (bench_port/configs/kk800.json) at a CPU size: scene 2, KK,
# Re 1000, dt 0.0125/res (a quarter of the CLI's default, inside KK's
# forward-Euler bound up to the velocity limit), confinement 5, dye, SOR
# ω 1.3 ×2, limit 10.
KK800_RES = 24


def test_kk800_settings_hold_100_steps_to_jax():
    """100 steps of the port's path (the wrappers' plain versions on the
    CPU) against the JAX package's, every leaf within STEP_TOL."""
    kw = {"scheme": "kk", "re": 1000.0, "dt": 0.0125 / KK800_RES, "vor_eps": 5.0}
    jax_scene, t_scene = _scene_pair(2, KK800_RES)
    jcfg = JaxConfig.create(resolution=KK800_RES, kernels="xla", **kw)
    start = _np_state(_seeded_state(jax_scene, jcfg))
    ref = _np_state(jax_make_run_fn(jcfg)(_seeded_state(jax_scene, jcfg), jax_scene, 100))
    assert int(ref["step"]) == 100 and np.isfinite(ref["v"]).all()
    cfg = ft.SimConfig.create(resolution=KK800_RES, **kw)
    assert cfg.enable_dye and cfg.pressure_solver == "sor" and cfg.n_pressure_iter == 2
    got = state_to_numpy(ft.make_run_fn(cfg)(state_from_numpy(start, "cpu"), t_scene, 100))
    assert set(got) == set(ref) and len(ref) == _leaf_count(cfg)
    names = sorted(ref)
    _assert_close([got[n] for n in names], [ref[n] for n in names], names, STEP_TOL)
