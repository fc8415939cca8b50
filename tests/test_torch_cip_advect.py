"""The port's standalone CIP advection (C1,
``fluid2d_tpu_torch/ops/cuda_stencil.py:cip_advect_cuda``) against the JAX
package's ``cip_advect_pallas`` (interpret mode) and its jnp
``where(fluid, cip_advect(...), alt)``, on the CPU, where the wrapper takes
its plain version. The cases mirror tests/test_pallas.py:17-72: 2 and 3
channels at JAX tiles of 8 and 16 rows, the velocity advecting itself
(``vel is f``), and alternating-sign upwind bands that cross the tile edges.

Tolerances: float32 within 1e-5·max(1, |ref|max), the JAX package's own
Pallas-against-jnp tolerance (the Pallas body multiplies by hoisted
reciprocals, ≤1 ulp from the literal divides). bf16: inputs rounded to bf16,
the JAX kernel run on bf16 arrays in interpret mode, the port on bf16
tensors; within one bf16 unit, 2⁻⁸·max(1, |ref|max): float32 differences of
an ulp between the two can flip a rounding.

Also the wrapper's byte ledger (the registered mixes ``cip_advect`` and
``cip_advect_self``) and its refusal of an output that aliases an input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid2d_tpu.ops.cip import cip_advect as jax_cip_advect
from fluid2d_tpu.ops.pallas_stencil import cip_advect_pallas
from fluid2d_tpu_torch.ops import launch
from fluid2d_tpu_torch.ops.cuda_stencil import cip_advect_cuda, cip_advect_name, cip_advect_plain
from fluid2d_tpu_torch.utils import profiling

torch.set_num_threads(1)

TOL = 1e-5
BF16_TOL = 2.0**-8


def _inputs(seed, chans, x_rows, y_cols, self_advect=False):
    """Seeded float32 NumPy inputs: f, fx, fy, vel (None when the velocity is
    f), three alternates and the fluid mask."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    f, fx, fy = mk(chans, x_rows, y_cols), mk(chans, x_rows, y_cols), mk(chans, x_rows, y_cols)
    vel = None if self_advect else mk(2, x_rows, y_cols)
    alts = [mk(chans, x_rows, y_cols) for _ in range(3)]
    fluid8 = (rng.random((x_rows, y_cols)) > 0.3).astype(np.int8)
    return f, fx, fy, vel, alts, fluid8


def _port(f, fx, fy, vel, alts, fluid8, dt, dx, dtype=torch.float32):
    """The port's call on CPU tensors of `dtype`; vel None → vel is f."""
    t = [torch.from_numpy(a).to(dtype) for a in (f, fx, fy)]
    v = t[0] if vel is None else torch.from_numpy(vel).to(dtype)
    ta = [torch.from_numpy(a).to(dtype) for a in alts]
    return cip_advect_cuda(*t, v, *ta, torch.from_numpy(fluid8), dt, dx)


def _jax_kernel(f, fx, fy, vel, alts, fluid8, dt, dx, tile, dtype=jnp.float32):
    jf = [jnp.asarray(a, dtype) for a in (f, fx, fy)]
    jv = jf[0] if vel is None else jnp.asarray(vel, dtype)
    ja = [jnp.asarray(a, dtype) for a in alts]
    return cip_advect_pallas(*jf, jv, *ja, jnp.asarray(fluid8), dt, dx, tile_x=tile,
                             interpret=True)


def _jax_jnp(f, fx, fy, vel, alts, fluid8, dt, dx):
    v = f if vel is None else vel
    ref = jax_cip_advect(jnp.asarray(f), jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(v[0]),
                         jnp.asarray(v[1]), dt, dx)
    return [np.asarray(jnp.where(fluid8 != 0, r, a)) for r, a in zip(ref, alts)]


def _assert_within(got, refs, tol, what):
    for name, g, r in zip(("fn", "fxn", "fyn"), got, refs):
        g = g.float().numpy()
        r = np.asarray(r, np.float32)
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=tol * scale, rtol=0, err_msg=f"{what} {name}")


@pytest.mark.parametrize("chans", [2, 3])
@pytest.mark.parametrize("tile", [8, 16])
def test_cip_advect_matches_jax(chans, tile):
    dt, dx = 0.002, 0.05
    ins = _inputs(9 + chans + tile, chans, 48, 20)
    got = _port(*ins, dt, dx)
    assert all(g.dtype == torch.float32 and g.shape == (chans, 48, 20) for g in got)
    _assert_within(got, _jax_jnp(*ins, dt, dx), TOL, "jnp")
    _assert_within(got, _jax_kernel(*ins, dt, dx, tile), TOL, "pallas")


def test_cip_advect_self_advection_matches_jax():
    """vel is f: the velocity advects itself through f's first two planes."""
    dt, dx = 0.002, 0.05
    ins = _inputs(11, 2, 32, 12, self_advect=True)
    got = _port(*ins, dt, dx)
    _assert_within(got, _jax_jnp(*ins, dt, dx), TOL, "jnp")
    _assert_within(got, _jax_kernel(*ins, dt, dx, 8), TOL, "pallas")


def test_cip_advect_upwind_bands_match_jax():
    """Alternating-sign velocity bands of 4 rows force upwind reads across
    the 8-row tile edges and the grid edges in every direction."""
    x_rows, y_cols = 32, 12
    dt, dx = 0.01, 0.1
    f, fx, fy, _, _, _ = _inputs(12, 2, x_rows, y_cols)
    u = (np.tile(np.repeat([1.0, -1.0], 4), x_rows // 8)[:, None]
         * np.ones((x_rows, y_cols))).astype(np.float32)
    vel = np.stack([u, -u])
    alts = [np.zeros((2, x_rows, y_cols), np.float32) for _ in range(3)]
    fluid8 = np.ones((x_rows, y_cols), np.int8)
    ins = (f, fx, fy, vel, alts, fluid8)
    got = _port(*ins, dt, dx)
    _assert_within(got, _jax_jnp(*ins, dt, dx), TOL, "jnp")
    _assert_within(got, _jax_kernel(*ins, dt, dx, 8), TOL, "pallas")


@pytest.mark.parametrize(("chans", "self_advect"), [(3, False), (2, False), (2, True)],
                         ids=["dye_form", "two_channels", "velocity_form"])
def test_cip_advect_bf16_matches_jax_kernel(chans, self_advect):
    """bf16 inputs: the JAX kernel on bf16 arrays in interpret mode (bf16
    widened at load, each output rounded once) against the port on bf16
    tensors, within one bf16 unit; the outputs are bf16."""
    dt, dx = 0.002, 0.05
    f, fx, fy, vel, alts, fluid8 = _inputs(13 + chans, chans, 32, 16, self_advect)
    rnd = [np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())
           for a in (f, fx, fy, *alts)]
    vel = None if vel is None else np.asarray(torch.from_numpy(vel).to(torch.bfloat16).float())
    ins = (*rnd[:3], vel, rnd[3:], fluid8)
    got = _port(*ins, dt, dx, dtype=torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in got)
    ref = _jax_kernel(*ins, dt, dx, 8, dtype=jnp.bfloat16)
    assert all(r.dtype == jnp.bfloat16 for r in ref)
    _assert_within(got, [np.asarray(r.astype(jnp.float32)) for r in ref], BF16_TOL, "pallas bf16")
    # the plain version rounds once: the float32 result of the widened inputs
    f32 = _port(*ins, dt, dx)
    for g, w in zip(got, f32):
        assert torch.equal(g, w.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cip_advect_logs_its_registered_mix(dtype):
    """The two forms log their registered mix bytes at the dtype's itemsize;
    another channel count logs its own name, unregistered."""
    x_rows, y_cols = 16, 8
    cases = {("cip_advect", 3, False), ("cip_advect_self", 2, True),
             ("cip_advect_c2", 2, False), ("cip_advect_self_c3", 3, True)}
    for name, chans, self_advect in cases:
        assert cip_advect_name(chans, self_advect) == name
        ins = _inputs(5, chans, x_rows, y_cols, self_advect)
        launch.TRAFFIC_LOG = ledger = []
        try:
            _port(*ins, 0.002, 0.05, dtype=dtype)
        finally:
            launch.TRAFFIC_LOG = None
        planes = (3 + 3 + 3) * chans + (0 if self_advect else 2)
        want = (planes * dtype.itemsize + 1) * x_rows * y_cols
        assert ledger == [(name, want)], name
        registered = profiling.mix_bytes(name, x_rows, y_cols, dtype.itemsize)
        assert registered == (want if name in ("cip_advect", "cip_advect_self") else None), name


def test_cip_advect_refuses_an_aliased_output_and_fills_out():
    f, fx, fy, vel, alts, fluid8 = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                                    [torch.from_numpy(b) for b in a]
                                    for a in _inputs(6, 3, 16, 8))
    args = (f, fx, fy, vel, *alts, fluid8, 0.002, 0.05)
    with pytest.raises(ValueError, match="aliases"):
        cip_advect_cuda(*args, out=(torch.empty_like(f), fx, torch.empty_like(f)))
    with pytest.raises(ValueError, match="aliases"):
        cip_advect_cuda(*args, out=(vel[1:].clone(), torch.empty_like(f), alts[0][1:]))
    out = tuple(torch.empty_like(f) for _ in range(3))
    got = cip_advect_cuda(*args, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, r in zip(got, cip_advect_plain(*args)):
        assert torch.equal(g, r)
    one = f[:1]
    with pytest.raises(ValueError, match="C ≥ 2"):
        cip_advect_cuda(one, fx[:1], fy[:1], one, *(a[:1] for a in alts), fluid8, 0.002, 0.05)
