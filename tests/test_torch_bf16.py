"""bf16 transport in the port (SimConfig.dtype="bfloat16": the state and the
scene's float planes stored in bf16, all arithmetic float32), on the CPU:

(a) rounding points, exact: each kernel's plain version, and
    ``update_pressure_and_limit``, on bf16 inputs equals the same function
    on the inputs widened to float32, rounded to bf16 — bit for bit. So each
    output is rounded once, from the float32 value (the CUDA kernels are held
    to these plain versions bit for bit on the card, tests/test_torch_cuda.py);
(b) each phase's plain version against the JAX package's jnp path
    (``kernels="xla"``, ``scene_for_dtype``) on the same bf16 inputs: every
    output within 2⁻⁸·max(1, |ref|max), one bf16 unit at the field's scale
    (float32 differences of ≤5e-7 between the two libraries can flip a
    rounding);
(c) the slice against the JAX package from the seeded state of
    tests/test_torch_step.py: one step within 2⁻⁷·max(1, |ref|max) on every
    leaf; three steps without confinement within 0.03·max(1, |ref|max), the
    JAX package's own bf16 bound between its two paths (tests/test_bf16.py);
(d) mirrors of tests/test_bf16.py: the leaves stay bf16 through
    ``make_run_fn``, a bf16 run tracks the float32 run within 0.08 of scale,
    ``field_to_numpy`` widens to float32, the façade's scene is bf16;
(e) ``convert`` at bf16: JAX → port → JAX is exact.

Inputs are seeded NumPy arrays rounded to bf16 and handed to both packages
(as float32 arrays holding bf16 values: NumPy has no bf16 of its own).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid2d_tpu.config import SimConfig as JaxConfig
from fluid2d_tpu.models import common as jcommon
from fluid2d_tpu.models.cip import cip_step as jax_cip_step
from fluid2d_tpu.models.mac import mac_step as jax_mac_step
from fluid2d_tpu.models.simulator import make_run_fn as jax_make_run_fn
from fluid2d_tpu.models.simulator import scene_for_dtype as jax_scene_for_dtype
from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
from fluid2d_tpu.state import init_state as jax_init_state
import fluid2d_tpu_torch as ft
from fluid2d_tpu_torch.convert import scene_from_numpy, state_from_numpy, state_to_numpy
from fluid2d_tpu_torch.models import common as tcommon
from fluid2d_tpu_torch.ops import cuda_phases, cuda_stencil

torch.set_num_threads(1)

RES = 24  # scene 2 on a (48, 24) grid
SHAPE = (2 * RES, RES)
RE = 1000.0
BF = torch.bfloat16
ULP_TOL = 2.0**-8
STEP1_TOL = 2.0**-7
STEPS3_TOL = 0.03

JAX_SCENE_F32 = jax_get_scene(2, RES)
SCENE_NP = {k: np.asarray(v) for k, v in zip(JAX_SCENE_F32._fields, JAX_SCENE_F32)}
T_SCENE = scene_from_numpy(SCENE_NP, "cpu", dtype=BF)
T_SCENE_WIDE = T_SCENE._replace(bc_const=T_SCENE.bc_const.float(), bc_dye=T_SCENE.bc_dye.float())
JCFG = JaxConfig.create(resolution=RES, re=RE, kernels="xla", dtype="bfloat16")
J_SCENE = jax_scene_for_dtype(JAX_SCENE_F32, JCFG)
DT, DX = JCFG.dt, JCFG.dx


def _bf(seed, lead=(), scale=1.0, offset=0.0) -> np.ndarray:
    """Seeded normal values rounded to bf16, as float32."""
    a = offset + scale * np.random.default_rng(seed).standard_normal((*lead, *SHAPE))
    return torch.from_numpy(a.astype(np.float32)).to(BF).float().numpy()


def _t(a: np.ndarray, dtype=BF) -> torch.Tensor:
    return torch.from_numpy(a.copy()).to(dtype)


def _j(a: np.ndarray):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, ref, names, tol):
    assert len(got) == len(ref) == len(names)
    for name, g, r in zip(names, got, ref):
        if isinstance(g, torch.Tensor):
            assert g.dtype == BF, f"{name}: {g.dtype}"
        g, r = _np(g), _np(r)
        assert g.shape == r.shape, f"{name}: {g.shape} vs {r.shape}"
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=tol * scale, rtol=0, err_msg=name)


# --- inputs of each plain version -------------------------------------------------


def _pressure_np():
    # u, w ~ N(0, 8²): many cells exceed the limit of 10, so the limiter bites.
    return [_bf(1, (), 0.3), _bf(2, (), 0.3), _bf(3, (), 8.0), _bf(4, (), 8.0)]


def _plain_cases():
    """name → (numpy inputs, a function calling the plain version on
    tensors of one dtype and the scene of that dtype)."""
    p, pa, u, w = _pressure_np()
    v, va = _bf(5, (2,), 0.5), _bf(6, (2,), 0.5)
    vg = [_bf(7 + k, (2,), 0.1) for k in range(4)]
    dye, da = _bf(11, (3,), 0.5, 0.5), _bf(12, (3,), 0.5, 0.5)
    dg = [_bf(13 + k, (3,), 0.1) for k in range(4)]
    cases = {
        "confinement": ([v, va], lambda a, sc: cuda_phases.confinement_plain(
            a[0], a[1], sc.fluid8, DT, 5.0, DX)),
        "cip_velocity_phase": ([v, p, va, *vg], lambda a, sc: cuda_phases.cip_velocity_phase_plain(
            *a, sc, RE, DT, DX)),
        "cip_dye_phase": ([dye, da, *dg, v], lambda a, sc: cuda_phases.cip_dye_phase_plain(
            *a, sc, RE, DT, DX)),
    }
    for scheme in ("upwind", "kk"):
        cases[f"mac_velocity_phase_{scheme}"] = (
            [v, p, va], lambda a, sc, s=scheme: cuda_phases.mac_velocity_phase_plain(
                *a, sc, s, RE, DT, DX))
        cases[f"mac_dye_phase_{scheme}"] = (
            [dye, da, v], lambda a, sc, s=scheme: cuda_phases.mac_dye_phase_plain(
                *a, sc, s, DT, DX))
    for lim in (None, 10.0):
        sfx = "" if lim is None else "_v_limit"
        cases["sor_iteration" + sfx] = ([p, pa, u, w], lambda a, sc, lim=lim: (
            cuda_stencil.sor_iteration_plain(*a, sc.pbc_code, sc.fluid8, 1.3, DT, DX,
                                             v_limit=lim)))
        for n in (1, 2, 4):
            cases[f"jacobi_iteration_n{n}{sfx}"] = ([p, pa, u, w], lambda a, sc, n=n, lim=lim: (
                cuda_stencil.jacobi_iteration_plain(*a, sc.pbc_code, sc.not_wall8, DT, DX,
                                                    n_iters=n, v_limit=lim)))
    for solver, n in (("sor", 1), ("sor", 2), ("sor", 3), ("jacobi", 2), ("jacobi", 6)):
        cfg = ft.SimConfig.create(resolution=RES, re=RE, pressure_solver=solver,
                                  n_pressure_iter=n)
        cases[f"update_pressure_and_limit_{solver}{n}"] = (
            [p, pa, np.stack([u, w])], lambda a, sc, cfg=cfg: tcommon.update_pressure_and_limit(
                *a, sc, cfg))
    return cases


PLAIN_CASES = _plain_cases()


# --- (a) rounding points ------------------------------------------------------------


@pytest.mark.parametrize("name", list(PLAIN_CASES))
def test_plain_rounds_once_from_float32(name):
    """plain(bf16 inputs) == plain(float32(inputs)).to(bf16), bit for bit."""
    arrays, call = PLAIN_CASES[name]
    got = call([_t(a) for a in arrays], T_SCENE)
    wide = call([_t(a, torch.float32) for a in arrays], T_SCENE_WIDE)
    assert len(got) == len(wide)
    for k, (g, w) in enumerate(zip(got, wide)):
        assert g.dtype == BF and w.dtype == torch.float32, f"{name}[{k}]"
        assert torch.equal(g, w.to(BF)), f"{name}[{k}]: not the float32 result rounded once"


def test_pressure_chain_returns_float32_between_calls():
    """A solve of two calls: the first returns a float32 pair, the last the
    bf16 pair and the bf16 limited velocity (the JAX package rounds once,
    after the chain)."""
    p, pa, u, w = (_t(a) for a in _pressure_np())
    mid = cuda_stencil.sor_iteration_plain(p, pa, u, w, T_SCENE.pbc_code, T_SCENE.fluid8, 1.3,
                                           DT, DX, out_dtype=torch.float32)
    assert [t.dtype for t in mid] == [torch.float32] * 2
    last = cuda_stencil.sor_iteration_plain(*mid, u, w, T_SCENE.pbc_code, T_SCENE.fluid8, 1.3,
                                            DT, DX, v_limit=10.0, out_dtype=BF)
    assert [t.dtype for t in last] == [BF] * 3
    with pytest.raises(TypeError, match="expected torch.bfloat16"):
        cuda_stencil.sor_iteration_plain(p.half(), pa.half(), u, w, T_SCENE.pbc_code,
                                         T_SCENE.fluid8, 1.3, DT, DX)


# --- (b) each phase against the JAX jnp path ------------------------------------------


def _jcfg(**kw):
    return JaxConfig.create(resolution=RES, re=RE, kernels="xla", dtype="bfloat16", **kw)


# The JAX step reduced to its phases: no confinement, no pressure iteration,
# a velocity limit that never bites.
_PHASE_ONLY = dict(vor_eps=None, n_pressure_iter=0, velocity_limit=1e30)


def _jax_phase_step(scheme, state_kw):
    jcfg = _jcfg(scheme=scheme, **_PHASE_ONLY)
    st = jax_init_state(J_SCENE, jcfg)._replace(**{k: _j(a) for k, a in state_kw.items()})
    step = jax_cip_step if scheme == "cip" else jax_mac_step
    return jax.jit(functools.partial(step, cfg=jcfg))(st, J_SCENE)


def test_cip_phases_match_jax_jnp():
    v, va, p = _bf(21, (2,), 0.5), _bf(22, (2,), 0.5), _bf(23, (), 0.3)
    vx, vxa, vy, vya = (_bf(24 + k, (2,), 0.1) for k in range(4))
    dye, da = _bf(28, (3,), 0.5, 0.5), _bf(29, (3,), 0.5, 0.5)
    dx_, dxa, dy_, dya = (_bf(30 + k, (3,), 0.1) for k in range(4))
    ref = _jax_phase_step("cip", dict(v=v, v_alt=va, p=p, vx=vx, vx_alt=vxa, vy=vy, vy_alt=vya,
                                      dye=dye, dye_alt=da, dyex=dx_, dyex_alt=dxa, dyey=dy_,
                                      dyey_alt=dya))
    got = cuda_phases.cip_velocity_phase_plain(*(_t(a) for a in (v, p, va, vx, vxa, vy, vya)),
                                               T_SCENE, RE, DT, DX)
    names = ("v", "vx", "vy", "v_alt", "vx_alt", "vy_alt")
    _assert_close(got, [getattr(ref, n) for n in names], names, ULP_TOL)
    # The dye phase carried by the JAX step's own velocity, so that its
    # inputs are the same bf16 values.
    got = cuda_phases.cip_dye_phase_plain(*(_t(a) for a in (dye, da, dx_, dxa, dy_, dya)),
                                          _t(_np(ref.v)), T_SCENE, RE, DT, DX)
    names = ("dye", "dyex", "dyey", "dye_alt", "dyex_alt", "dyey_alt")
    _assert_close(got, [getattr(ref, n) for n in names], names, ULP_TOL)


@pytest.mark.parametrize("scheme", ["upwind", "kk"])
def test_mac_phases_match_jax_jnp(scheme):
    v, va, p = _bf(41, (2,), 0.5), _bf(42, (2,), 0.5), _bf(43, (), 0.3)
    dye, da = _bf(44, (3,), 0.5, 0.5), _bf(45, (3,), 0.5, 0.5)
    ref = _jax_phase_step(scheme, dict(v=v, v_alt=va, p=p, dye=dye, dye_alt=da))
    got = cuda_phases.mac_velocity_phase_plain(_t(v), _t(p), _t(va), T_SCENE, scheme, RE, DT, DX)
    _assert_close(got, [ref.v, ref.v_alt], ("v", "v_alt"), ULP_TOL)
    got = cuda_phases.mac_dye_phase_plain(_t(dye), _t(da), _t(_np(ref.v)), T_SCENE, scheme, DT,
                                          DX)
    _assert_close(got, [ref.dye, ref.dye_alt], ("dye", "dye_alt"), ULP_TOL)


def test_confinement_matches_jax_jnp():
    v, va = _bf(51, (2,), 0.5), _bf(52, (2,), 0.5)
    ref = jcommon.confinement(_j(v), _j(va), J_SCENE, _jcfg(vor_eps=5.0))
    got = cuda_phases.confinement_plain(_t(v), _t(va), T_SCENE.fluid8, DT, 5.0, DX)
    _assert_close(got, ref, ("v_cur", "v_alt"), ULP_TOL)


@pytest.mark.parametrize(("solver", "n"), [("sor", 1), ("sor", 2), ("jacobi", 1), ("jacobi", 4),
                                           ("jacobi", 6)])
def test_pressure_matches_jax_jnp(solver, n):
    """The port's solve, and where it is one call that call alone, against
    the JAX package's ``update_pressure_and_limit``."""
    p, pa, u, w = _pressure_np()
    jcfg = _jcfg(pressure_solver=solver, n_pressure_iter=n)
    ref = jcommon.update_pressure_and_limit(_j(p), _j(pa), _j(np.stack([u, w])), J_SCENE, jcfg)
    names = ("p_cur", "p_alt", "v_lim")
    cfg = ft.SimConfig.create(resolution=RES, re=RE, pressure_solver=solver, n_pressure_iter=n)
    got = tcommon.update_pressure_and_limit(_t(p), _t(pa), _t(np.stack([u, w])), T_SCENE, cfg)
    _assert_close(got, ref, names, ULP_TOL)
    args = (_t(p), _t(pa), _t(u), _t(w), T_SCENE.pbc_code)
    if solver == "sor" and n == 1:
        one = cuda_stencil.sor_iteration_plain(*args, T_SCENE.fluid8, 1.3, DT, DX, v_limit=10.0)
        _assert_close(one, ref, names, ULP_TOL)
    elif solver == "jacobi" and n <= 4:
        one = cuda_stencil.jacobi_iteration_plain(*args, T_SCENE.not_wall8, DT, DX, n_iters=n,
                                                  v_limit=10.0)
        _assert_close(one, ref, names, ULP_TOL)


# --- (c) the slice against the JAX package --------------------------------------------

RUNS = {
    "cip": {},
    "upwind": {"scheme": "upwind"},
    "kk": {"scheme": "kk"},
    "cip_jacobi": {"pressure_solver": "jacobi"},
}


def _seeded(jcfg):
    """tests/test_torch_step.py's smooth seeded state, in bf16."""
    st = jax_init_state(J_SCENE, jcfg)
    fluid = (np.asarray(J_SCENE.mask) == 0).astype(np.float32)
    gx = np.linspace(0, 2 * np.pi, SHAPE[0], dtype=np.float32)[:, None]
    gy = np.linspace(0, 2 * np.pi, SHAPE[1], dtype=np.float32)[None, :]
    v = np.stack([0.3 * np.sin(gx) * np.cos(2 * gy) * fluid,
                  0.2 * np.cos(2 * gx) * np.sin(gy) * fluid])
    dye = np.stack([0.5 + 0.4 * np.sin(k * gx) * np.cos(gy) * fluid for k in (1, 2, 3)])
    return st._replace(v=_j(v), p=_j(0.1 * np.sin(gx + gy) * fluid), dye=_j(dye))


def _jax_np(state) -> dict[str, np.ndarray]:
    return {k: (np.asarray(v) if k == "step" else _np(v))
            for k, v in zip(state._fields, state) if v is not None}


@pytest.mark.parametrize(("n_steps", "vor_eps", "tol"),
                         [(1, 5.0, STEP1_TOL), (3, None, STEPS3_TOL)])
@pytest.mark.parametrize("run", list(RUNS))
def test_bf16_run_matches_jax(run, n_steps, vor_eps, tol):
    kw = RUNS[run]
    jcfg = _jcfg(vor_eps=vor_eps, **kw)
    start = _jax_np(_seeded(jcfg))
    ref = _jax_np(jax_make_run_fn(jcfg)(_seeded(jcfg), J_SCENE, n_steps))
    assert int(ref["step"]) == n_steps and np.abs(ref["v"]).max() > 1e-3

    cfg = ft.SimConfig.create(resolution=RES, re=RE, vor_eps=vor_eps, dtype="bfloat16", **kw)
    out = ft.make_run_fn(cfg)(state_from_numpy(start, "cpu", dtype=BF), T_SCENE, n_steps)
    assert all(leaf.dtype == BF for name, leaf in zip(out._fields, out)
               if leaf is not None and name != "step")
    got = state_to_numpy(out)
    assert set(got) == set(ref)
    for name, r in ref.items():
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(got[name], r, atol=tol * scale, rtol=0, err_msg=name)


# --- (d) mirrors of tests/test_bf16.py ---------------------------------------------------

SCHEMES = ("upwind", "kk", "cip")


def _run(scheme, dtype, steps=5):
    cfg = ft.SimConfig.create(resolution=RES, re=100.0, scheme=scheme, vor_eps=5.0, dtype=dtype)
    scene = ft.scene_for_dtype(ft.get_scene(2, RES, "cpu"), cfg)
    return ft.make_run_fn(cfg)(ft.init_state(scene, cfg, "cpu"), scene, steps)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bf16_state_dtype_preserved_through_run(scheme):
    state = _run(scheme, "bfloat16")
    for name, leaf in zip(state._fields, state):
        if name == "step" or leaf is None:
            continue
        assert leaf.dtype == BF, name
    assert state.step.dtype == torch.int32


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bf16_tracks_f32(scheme):
    s16, s32 = _run(scheme, "bfloat16"), _run(scheme, "float32")
    for name in ("v", "p", "dye"):
        a, b = getattr(s16, name).float(), getattr(s32, name)
        assert bool(torch.isfinite(a).all()), name
        scale = max(float(b.abs().max()), 1e-3)
        err = float((a - b).abs().max()) / scale
        assert err < 0.08, f"{name}: relative error {err:.4f}"


def test_bf16_simulator_scene_and_field_dump():
    sim = ft.FluidSimulator.create(bc_num=1, resolution=RES, device="cpu", re=100.0,
                                   scheme="upwind", dtype="bfloat16")
    assert sim.scene.bc_const.dtype == BF and sim.scene.bc_dye.dtype == BF
    assert sim.scene.fluid8.dtype == torch.int8
    sim.step(2)
    assert sim.state.v.dtype == BF
    fields = sim.field_to_numpy()
    assert fields["v"].dtype == np.float32 and fields["p"].dtype == np.float32
    np.testing.assert_array_equal(fields["p"], sim.state.p.float().numpy())


def test_scene_for_dtype_matches_jax():
    cfg = ft.SimConfig.create(resolution=RES, dtype="bfloat16")
    got = ft.scene_for_dtype(ft.get_scene(2, RES, "cpu"), cfg)
    for name in ("bc_const", "bc_dye"):
        assert getattr(got, name).dtype == BF
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(J_SCENE, name)))
    f32 = ft.SimConfig.create(resolution=RES)
    scene = ft.get_scene(2, RES, "cpu")
    assert ft.scene_for_dtype(scene, f32) is scene


def test_config_accepts_bf16_and_refuses_other_dtypes():
    assert ft.SimConfig.create(resolution=RES, dtype="bfloat16").dtype == "bfloat16"
    with pytest.raises(ValueError, match="transport dtype"):
        ft.SimConfig.create(resolution=RES, dtype="float64")


# --- (e) convert at bf16 ---------------------------------------------------------------


def test_convert_round_trip_at_bf16_is_exact():
    jcfg = _jcfg()
    state = jax_make_run_fn(jcfg)(_seeded(jcfg), J_SCENE, 2)
    arrays = _jax_np(state)
    port = state_from_numpy(arrays, "cpu", dtype="bfloat16")
    for name, leaf in zip(port._fields, port):
        if leaf is not None:
            assert leaf.dtype == (torch.int32 if name == "step" else BF), name
    back = state_to_numpy(port)
    assert set(back) == set(arrays)
    for name, a in arrays.items():
        assert back[name].dtype == a.dtype, name
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    scene = scene_from_numpy(SCENE_NP, "cpu", dtype="bfloat16")
    np.testing.assert_array_equal(_np(scene.bc_const), _np(J_SCENE.bc_const))
    assert scene.pbc_code.dtype == torch.int8
