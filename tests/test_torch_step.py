"""The port's main path as a whole against the JAX package: the seeded
state of __graft_entry__.py on scene 2 (res=32, default CIP config: dye,
confinement ε=5, SOR ×2, limit 10) is carried into the port through
``convert``, run by both ``make_run_fn``s, and every SimState leaf —
alternates and CIP gradient planes included — is compared within
2e-5·max(1, |ref|max), the ROADMAP's multi-step tolerance.

Also: the NumPy exchange round-trips exactly, the package never imports
JAX, and the config accepts every scheme and solver and refuses what the
JAX package refuses. bf16 transport is held to the JAX package in
tests/test_torch_bf16.py. The MAC and Jacobi runs are held to the JAX package in
tests/test_torch_mac.py."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fluid2d_tpu.config import SimConfig as JaxConfig
from fluid2d_tpu.models.simulator import make_run_fn as jax_make_run_fn
from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
from fluid2d_tpu.state import init_state as jax_init_state
import fluid2d_tpu_torch as ft
from fluid2d_tpu_torch.convert import scene_from_numpy, state_from_numpy, state_to_numpy

torch.set_num_threads(1)

RES = 32
TOL = 2e-5
REPO = Path(__file__).resolve().parents[1]

JAX_SCENE = jax_get_scene(2, RES)
T_SCENE = scene_from_numpy({k: np.asarray(v) for k, v in zip(JAX_SCENE._fields, JAX_SCENE)},
                           "cpu")


def _seeded_state(cfg):
    """__graft_entry__.py's smooth seeded state: non-trivial gradients in
    every field within a few steps, off the confinement 0/0 discontinuity."""
    st = jax_init_state(JAX_SCENE, cfg)
    x_rows, y_cols = st.p.shape
    fluid = (np.asarray(JAX_SCENE.mask) == 0).astype(np.float32)
    gx = np.linspace(0, 2 * np.pi, x_rows, dtype=np.float32)[:, None]
    gy = np.linspace(0, 2 * np.pi, y_cols, dtype=np.float32)[None, :]
    u = 0.3 * np.sin(gx) * np.cos(2 * gy) * fluid
    w = 0.2 * np.cos(2 * gx) * np.sin(gy) * fluid
    v = jnp.stack([jnp.asarray(u), jnp.asarray(w)])
    p = jnp.asarray(0.1 * np.sin(gx + gy) * fluid)
    dye = jnp.stack([jnp.asarray(0.5 + 0.4 * np.sin(k * gx) * np.cos(gy) * fluid)
                     for k in (1, 2, 3)])
    return st._replace(v=v, p=p, dye=dye)


def _np(state) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in zip(state._fields, state) if v is not None}


# State leaves with dye on: step + the v and p pairs, + the CIP gradient
# pairs of v and dye; MAC keeps only the dye pair beside them.
LEAVES = {"cip": 15, "upwind": 7, "kk": 7}


def _assert_states_close(got: dict, ref: dict, scheme: str = "cip") -> None:
    assert set(got) == set(ref)
    assert len(ref) == LEAVES[scheme]
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape and g.dtype == r.dtype, name
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=TOL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize(("jax_kernels", "n_steps"),
                         [("xla", 4), ("xla", 3), ("pallas_interpret", 2)])
def test_port_run_matches_jax(jax_kernels, n_steps):
    jcfg = JaxConfig.create(resolution=RES, kernels=jax_kernels)
    start = _np(_seeded_state(jcfg))
    ref = _np(jax_make_run_fn(jcfg)(_seeded_state(jcfg), JAX_SCENE, n_steps))
    assert np.abs(ref["v"]).max() > 1e-3 and int(ref["step"]) == n_steps

    cfg = ft.SimConfig.create(resolution=RES)
    got = state_to_numpy(ft.make_run_fn(cfg)(state_from_numpy(start, "cpu"), T_SCENE, n_steps))
    _assert_states_close(got, ref)


def test_state_numpy_round_trip_is_exact():
    jcfg = JaxConfig.create(resolution=RES, kernels="xla")
    start = _np(jax_make_run_fn(jcfg)(_seeded_state(jcfg), JAX_SCENE, 1))
    back = state_to_numpy(state_from_numpy(start, "cpu"))
    assert set(back) == set(start)
    for name, a in start.items():
        assert back[name].dtype == a.dtype, name
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    with pytest.raises(KeyError, match="not SimState fields"):
        state_from_numpy({**start, "bogus": start["p"]}, "cpu")


def test_init_state_matches_jax():
    jcfg = JaxConfig.create(resolution=RES)
    ref = _np(jax_init_state(JAX_SCENE, jcfg))
    got = state_to_numpy(ft.init_state(T_SCENE, ft.SimConfig.create(resolution=RES), "cpu"))
    assert set(got) == set(ref)
    for name, a in ref.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


def test_simulator_facade_runs_on_cpu():
    sim = ft.FluidSimulator.create(bc_num=2, resolution=16, device="cpu")
    sim.step(3)
    assert int(sim.state.step) == 3
    fields = sim.field_to_numpy()
    assert fields["v"].shape == (32, 16, 2) and fields["dye"].shape == (32, 16, 3)
    assert all(np.isfinite(a).all() for a in fields.values())
    assert np.abs(fields["v"]).max() > 0.1


def test_package_never_imports_jax():
    code = (
        "import sys\n"
        "import fluid2d_tpu_torch as ft\n"
        "ft.FluidSimulator.create(bc_num=2, resolution=16, device='cpu').step(2)\n"
        "ft.FluidSimulator.create(bc_num=2, resolution=16, device='cpu', scheme='kk',\n"
        "                         pressure_solver='jacobi').step(2)\n"
        "ft.FluidSimulator.create(bc_num=2, resolution=16, device='cpu', dtype='bfloat16').step(2)\n"
        "import fluid2d_tpu_torch.scripts.vpu_dtype_probe, fluid2d_tpu_torch.scripts.bf16_dma_probe\n"
        "import fluid2d_tpu_torch.scripts.bf16_geometry_probe\n"
        "import fluid2d_tpu_torch.scripts.vpu_rate_sweep, fluid2d_tpu_torch.scripts.dma_geometry_sweep\n"
        "import fluid2d_tpu_torch.scripts.dma_geometry_bench\n"
        "import fluid2d_tpu_torch.scripts.dma_rowwin_1600_check\n"
        "import fluid2d_tpu_torch.cli, fluid2d_tpu_torch.utils.viz, fluid2d_tpu_torch.utils.io\n"
        "import fluid2d_tpu_torch.utils.metrics, fluid2d_tpu_torch.utils.viewer\n"
        "import fluid2d_tpu_torch.utils.notes\n"
        "import fluid2d_tpu_torch.scripts.solver_residual_bench, fluid2d_tpu_torch.scripts.bf16_drift\n"
        "import contextlib, io, tempfile\n"
        "d = tempfile.mkdtemp()\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    fluid2d_tpu_torch.cli.main(['-bc', '2', '-res', '16', '--steps', '2', '--frame-every',\n"
        "                                '1', '--log-every', '1', '--dump-fields', '--output', d,\n"
        "                                '--checkpoint', d + '/c.npz', '--device', 'cpu'])\n"
        "    fluid2d_tpu_torch.cli.main(['--resume', d + '/c.npz', '--steps', '1', '--output', d,\n"
        "                                '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fluid2d_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_mode_refuses_cpu_tensors():
    cfg = ft.SimConfig.create(resolution=16, kernels="cuda")
    scene = ft.get_scene(2, 16, "cpu")
    with pytest.raises(ValueError, match='kernels="cuda" needs CUDA tensors'):
        ft.make_run_fn(cfg)(ft.init_state(scene, cfg, "cpu"), scene, 1)


# The ids stay those the cases have always had; every transport dtype of the
# JAX package is ported, so the dtype cases are the ones it refuses too.
@pytest.mark.parametrize(("kwargs", "match"), [
    pytest.param({"dtype": "float16", "scheme": "kk"}, "Unknown transport dtype",
                 id="kwargs0-not ported"),
    ({"scheme": "bogus"}, "Unknown scheme"),
    ({"pressure_solver": "bogus"}, "Unknown pressure solver"),
    pytest.param({"dtype": "float64"}, "Unknown transport dtype", id="kwargs3-not ported"),
    ({"kernels": "pallas"}, "Unknown kernels mode"),
])
def test_config_refuses_what_is_not_ported(kwargs, match):
    with pytest.raises(ValueError, match=match):
        ft.SimConfig.create(**kwargs)


@pytest.mark.parametrize("solver", ["sor", "jacobi"])
@pytest.mark.parametrize("scheme", ["upwind", "kk", "cip"])
def test_config_accepts_every_scheme_and_solver(scheme, solver):
    cfg = ft.SimConfig.create(resolution=16, scheme=scheme, pressure_solver=solver)
    assert (cfg.scheme, cfg.pressure_solver) == (scheme, solver)
    step = ft.make_step_fn(cfg)
    assert step.func.__name__ == ("cip_step" if scheme == "cip" else "mac_step")
    scene = ft.get_scene(2, 16, "cpu")
    state = step(ft.init_state(scene, cfg, "cpu"), scene)
    assert int(state.step) == 1
    assert len([leaf for leaf in state if leaf is not None]) == LEAVES[scheme]


def test_config_defaults_match_jax():
    got, ref = ft.SimConfig.create(resolution=1600), JaxConfig.create(resolution=1600)
    for name in ("resolution", "dt", "dx", "re", "scheme", "vor_eps", "enable_dye",
                 "pressure_solver", "sor_omega", "n_pressure_iter", "velocity_limit", "dtype"):
        assert getattr(got, name) == getattr(ref, name), name
    assert ft.SimConfig.create(vor_eps=0.0).vor_eps is None
