"""The port's eager ops against their JAX twins, on seeded random fields
and on scene-2 masks: stencils, runtime BCs, limiters, pressure, vorticity
and CIP. Tolerance: 1e-5·max(1, |ref|max) — the same float32 algebra,
evaluated by another library."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fluid2d_tpu.ops import cip as jcip
from fluid2d_tpu.ops import limiters as jlim
from fluid2d_tpu.ops import pressure as jpres
from fluid2d_tpu.ops import stencil as jst
from fluid2d_tpu.ops import vorticity as jvort
from fluid2d_tpu.scenes import runtime_bc as jbc
from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
from fluid2d_tpu_torch.convert import scene_from_numpy
from fluid2d_tpu_torch.ops import cip as tcip
from fluid2d_tpu_torch.ops import limiters as tlim
from fluid2d_tpu_torch.ops import pressure as tpres
from fluid2d_tpu_torch.ops import stencil as tst
from fluid2d_tpu_torch.ops import vorticity as tvort
from fluid2d_tpu_torch.scenes import runtime_bc as tbc

torch.set_num_threads(1)

RES = 16
SHAPE = (2 * RES, RES)
DT, DX, RE = 0.05 / RES, 1.0 / RES, 1000.0
TOL = 1e-5

JAX_SCENE = jax_get_scene(2, RES)
T_SCENE = scene_from_numpy({k: np.asarray(v) for k, v in zip(JAX_SCENE._fields, JAX_SCENE)},
                           "cpu")


def _rand(seed, lead=(), scale=1.0, nan_frac=0.0):
    rng = np.random.default_rng(seed)
    a = (scale * rng.standard_normal((*lead, *SHAPE))).astype(np.float32)
    if nan_frac:
        a[rng.random(a.shape) < nan_frac] = np.nan
    return a


def _check(got, ref, name):
    if not isinstance(ref, tuple):
        got, ref = (got,), (ref,)
    assert len(got) == len(ref), name
    for k, (g, r) in enumerate(zip(got, ref)):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape, f"{name}[{k}]"
        finite = r[np.isfinite(r)]
        scale = max(1.0, float(np.abs(finite).max()) if finite.size else 1.0)
        np.testing.assert_allclose(g, r, atol=TOL * scale, rtol=0, err_msg=f"{name}[{k}]")


def _run(name, jax_fn, torch_fn, arrays, *extra_j, extra_t=None):
    """Call both twins on the same NumPy inputs (+ trailing extras)."""
    extra_t = extra_j if extra_t is None else extra_t
    ref = jax_fn(*(jnp.asarray(a) for a in arrays), *extra_j)
    got = torch_fn(*(torch.from_numpy(a.copy()) for a in arrays), *extra_t)
    _check(got, ref, name)


@pytest.mark.parametrize("d", [-2, -1, 0, 1, 2])
@pytest.mark.parametrize("op", ["shift_x", "shift_y"])
def test_shift(op, d):
    a = _rand(1, (2,))
    _run(op, getattr(jst, op), getattr(tst, op), [a], d)


def test_shift2_and_sign():
    a = _rand(2, (3,))
    a[0, 0, :4] = [0.0, -0.0, np.nan, -1e-30]
    _run("shift2", jst.shift2, tst.shift2, [a], 2, -1)
    _run("sign", jst.sign, tst.sign, [a])


@pytest.mark.parametrize("op", ["tmin", "tmax"])
def test_tmin_tmax_nan_takes_the_constant(op):
    a = _rand(3, nan_frac=0.2)
    _run(op, getattr(jst, op), getattr(tst, op), [a], 0.1)
    got = getattr(tst, op)(torch.from_numpy(a), 0.1).numpy()
    assert not np.isnan(got).any()


@pytest.mark.parametrize("op", ["fdiff_x", "fdiff_y", "bdiff_x", "bdiff_y",
                                "diff_x", "diff_y", "diff2_x", "diff2_y"])
def test_differences(op):
    _run(op, getattr(jst, op), getattr(tst, op), [_rand(4, (2,))], DX)


def test_velocity_bc():
    a = _rand(5, (2,), nan_frac=0.05)  # NaN upstream of outflow → 0.05
    _run("velocity_bc", jbc.velocity_bc, tbc.velocity_bc, [a], JAX_SCENE, extra_t=(T_SCENE,))


def test_pressure_and_dye_bc():
    _run("pressure_bc", jbc.pressure_bc, tbc.pressure_bc, [_rand(6)], JAX_SCENE,
         extra_t=(T_SCENE,))
    _run("dye_bc", jbc.dye_bc, tbc.dye_bc, [_rand(7, (3,))], JAX_SCENE, extra_t=(T_SCENE,))


def test_limiters():
    v = _rand(8, (2,), scale=8.0, nan_frac=0.05)
    _run("limit_vector_norm", jlim.limit_vector_norm, tlim.limit_vector_norm, [v], 10.0)
    d = _rand(9, (3,), nan_frac=0.1)
    _run("clamp_field", jlim.clamp_field, tlim.clamp_field, [d], 0.0, 1.0)
    assert tlim.clamp_field(torch.from_numpy(d), 0.0, 1.0)[torch.from_numpy(np.isnan(d))].eq(0).all()


def test_predict_p_and_sor_iteration():
    p, pa, u, w = _rand(10), _rand(11), _rand(12), _rand(13)
    _run("predict_p", jpres.predict_p, tpres.predict_p, [p, u, w], DT, DX)
    _run("sor_pressure_iteration",
         lambda p_, pa_, u_, w_: jpres.sor_pressure_iteration(p_, pa_, u_, w_, JAX_SCENE, 1.3, DT, DX),
         lambda p_, pa_, u_, w_: tpres.sor_pressure_iteration(p_, pa_, u_, w_, T_SCENE, 1.3, DT, DX),
         [p, pa, u, w])


def test_vorticity_confinement():
    v, va = _rand(14, (2,), 0.5), _rand(15, (2,), 0.5)
    v[:, :, :6] = 0.25  # a uniform patch: zero |curl| gradient, the 0/0 → +0.1 rule
    fluid_j, fluid_t = JAX_SCENE.fluid, T_SCENE.fluid
    _run("confinement_force", lambda v_: jvort.confinement_force(v_, fluid_j, DX),
         lambda v_: tvort.confinement_force(v_, fluid_t, DX), [v])
    force = tvort.confinement_force(torch.from_numpy(v), fluid_t, DX)
    assert (force[:, fluid_t] == 0.1).any(), "the 0/0 → +0.1 cells were not exercised"
    _run("apply_confinement", lambda a, b: jvort.apply_confinement(a, b, fluid_j, DT, 5.0, DX),
         lambda a, b: tvort.apply_confinement(a, b, fluid_t, DT, 5.0, DX), [v, va])


def test_cip_non_advection():
    f, p = _rand(16, (2,)), _rand(17)
    fx, fy, fnew = _rand(18, (2,)), _rand(19, (2,)), _rand(20, (2,))
    _run("grad_of", jcip.grad_of, tcip.grad_of, [f], DX)
    _run("non_advection_velocity", jcip.non_advection_velocity, tcip.non_advection_velocity,
         [f, p], RE, DT, DX)
    _run("non_advection_diffusion", jcip.non_advection_diffusion, tcip.non_advection_diffusion,
         [_rand(21, (3,))], RE, DT, DX)
    _run("non_advection_grad", jcip.non_advection_grad, tcip.non_advection_grad,
         [fx, fy, f, fnew], DX)


@pytest.mark.parametrize("chans", [2, 3])
def test_cip_advect(chans):
    f, fx, fy = _rand(22, (chans,)), _rand(23, (chans,), 0.1), _rand(24, (chans,), 0.1)
    u, w = _rand(25, scale=0.5), _rand(26, scale=0.5)
    u[::3, ::2] = 0.0  # sign(0) takes the +1 branch
    _run("cip_advect", jcip.cip_advect, tcip.cip_advect, [f, fx, fy, u, w], DT, DX)
