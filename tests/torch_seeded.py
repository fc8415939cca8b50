"""Seeded states shared by the port's front-end tests: the smooth state of
__graft_entry__.py on scene 2 (fluid cells only), advanced one step by the
JAX package so that every leaf — alternates and CIP gradient planes
included — holds data. A run from the zero state is ill-conditioned
(confinement's 0/0 rule), so the packages are compared from this state."""

import jax.numpy as jnp
import numpy as np

from fluid2d_tpu.config import SimConfig as JaxConfig
from fluid2d_tpu.models.simulator import make_run_fn as jax_make_run_fn
from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
from fluid2d_tpu.state import init_state as jax_init_state

TOL = 2e-5  # a resumed 4-step run: every leaf within TOL·max|field|


def jax_scene(res: int, bc: int = 2):
    return jax_get_scene(bc, res)


def jax_seeded_state(res: int, dtype: str = "float32", steps: int = 1):
    """(state, scene, cfg) of the JAX package, kernels="xla": the seeded
    state after `steps` steps."""
    cfg = JaxConfig.create(resolution=res, kernels="xla", dtype=dtype)
    scene = jax_get_scene(2, res)
    st = jax_init_state(scene, cfg)
    x_rows, y_cols = st.p.shape
    fluid = (np.asarray(scene.mask) == 0).astype(np.float32)
    gx = np.linspace(0, 2 * np.pi, x_rows, dtype=np.float32)[:, None]
    gy = np.linspace(0, 2 * np.pi, y_cols, dtype=np.float32)[None, :]
    u = 0.3 * np.sin(gx) * np.cos(2 * gy) * fluid
    w = 0.2 * np.cos(2 * gx) * np.sin(gy) * fluid
    dye = np.stack([0.5 + 0.4 * np.sin(k * gx) * np.cos(gy) * fluid for k in (1, 2, 3)])
    dt = jnp.dtype(dtype)
    st = st._replace(v=jnp.asarray(np.stack([u, w])).astype(dt),
                     p=jnp.asarray(0.1 * np.sin(gx + gy) * fluid).astype(dt),
                     dye=jnp.asarray(dye).astype(dt))
    if steps:
        st = jax_make_run_fn(cfg)(st, scene, steps)
    return st, scene, cfg


def leaves_np(state) -> dict[str, np.ndarray]:
    """Every non-None leaf as a host array, float leaves widened to float32."""
    out = {}
    for name, leaf in zip(state._fields, state):
        if leaf is None:
            continue
        if hasattr(leaf, "detach"):  # a torch tensor
            leaf = leaf.detach().cpu()
            out[name] = (leaf.float() if leaf.is_floating_point() else leaf).numpy()
        else:
            a = np.asarray(leaf)
            out[name] = a if a.dtype.kind in "iu" else a.astype(np.float32)
    return out


def assert_close_to_scale(got: dict, ref: dict, tol: float = TOL) -> None:
    """Same leaves; each within tol·max|ref field| (exact where the field is 0)."""
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g, r, atol=tol * scale, rtol=0, err_msg=name)
