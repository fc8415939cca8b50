"""The port's views (``fluid2d_tpu_torch/utils/viz.py``) against the JAX
package's (``fluid2d_tpu/utils/viz.py``) on one seeded state: every
colormap, ``_hsv_to_rgb`` and ``render_rgb`` vis 0–3, at float32 and at
bf16 transport, each frame within 1e-6 absolute (a raw colormap at
|v| ≈ 40, past the hue's first band, within 1e-6·max(1, |ref|max)); a NaN cell renders NaN
where the JAX package's does (``torch.maximum``, not ``fmax``);
``to_image`` within 1 LSB with the same orientation; walls painted; the
same ``ValueError``s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid2d_tpu.config import SimConfig as JaxConfig
from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
from fluid2d_tpu.state import init_state as jax_init_state
from fluid2d_tpu.utils import viz as jviz
from fluid2d_tpu_torch import SimConfig, get_scene
from fluid2d_tpu_torch.convert import scene_from_numpy, state_from_numpy
from fluid2d_tpu_torch.utils import viz

torch.set_num_threads(1)

RES = 16
TOL = 1e-6
JAX_SCENE = jax_get_scene(1, RES)
T_SCENE = scene_from_numpy({k: np.asarray(v) for k, v in zip(JAX_SCENE._fields, JAX_SCENE)},
                           "cpu")
DTYPES = ["float32", "bfloat16"]


def _fields(seed: int = 1) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "v": (3.0 * rng.standard_normal((2, 2 * RES, RES))).astype(np.float32),
        "p": rng.standard_normal((2 * RES, RES)).astype(np.float32),
        "dye": rng.random((3, 2 * RES, RES)).astype(np.float32),
    }


def _states(dtype: str, fields: dict | None = None, enable_dye: bool = True):
    """The same seeded state in both packages at `dtype` (bf16 values are
    rounded once, by the port, and carried to JAX exactly)."""
    fields = _fields() if fields is None else fields
    if not enable_dye:
        fields = {k: v for k, v in fields.items() if k != "dye"}
    jcfg = JaxConfig.create(resolution=RES, enable_dye=enable_dye, dtype=dtype)
    cfg = SimConfig.create(resolution=RES, enable_dye=enable_dye, dtype=dtype)
    tstate = state_from_numpy({**_np(jax_init_state(JAX_SCENE, jcfg)), **fields}, "cpu", dtype)
    widened = {k: getattr(tstate, k).float().numpy() for k in fields}
    jstate = jax_init_state(JAX_SCENE, jcfg)._replace(
        **{k: jnp.asarray(a).astype(jnp.dtype(dtype)) for k, a in widened.items()})
    return jstate, jcfg, tstate, cfg


def _np(state) -> dict[str, np.ndarray]:
    return {k: np.asarray(v, np.float32) if k != "step" else np.asarray(v)
            for k, v in zip(state._fields, state) if v is not None}


def _assert_frames_close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


def test_port_scene_walls_match_jax():
    np.testing.assert_array_equal(get_scene(1, RES, "cpu").wall.numpy(),
                                  np.asarray(JAX_SCENE.wall))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vis", [0, 1, 2, 3])
def test_render_rgb_matches_jax(vis, dtype):
    jstate, jcfg, tstate, cfg = _states(dtype)
    got = viz.render_rgb(tstate, T_SCENE, cfg, vis)
    _assert_frames_close(got, jviz.render_rgb(jstate, JAX_SCENE, jcfg, vis))
    assert np.abs(got.numpy()).max() > 0.01


@pytest.mark.parametrize("name", ["norm", "pressure", "vorticity", "xy", "hue"])
@pytest.mark.parametrize("scale", [3.0, 40.0])  # 40: |v| past the hue's first band
def test_colormaps_match_jax(name, scale):
    rng = np.random.default_rng(7)
    v = (scale * rng.standard_normal((2, 2 * RES, RES))).astype(np.float32)
    p = v[0] / scale
    tv, tp = torch.from_numpy(v), torch.from_numpy(p)
    dx = 1.0 / RES
    got, ref = {
        "norm": lambda: (viz.visualize_norm(tv), jviz.visualize_norm(v)),
        "pressure": lambda: (viz.visualize_pressure(tp), jviz.visualize_pressure(p)),
        "vorticity": lambda: (viz.visualize_vorticity(tv, dx), jviz.visualize_vorticity(v, dx)),
        "xy": lambda: (viz.visualize_xy(tv), jviz.visualize_xy(v)),
        "hue": lambda: (viz.visualize_hue(tv), jviz.visualize_hue(v)),
    }[name]()
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape == (2 * RES, RES, 3)
    # 1e-6 absolute on the seeded scale; at |v| ≈ 40 the raw norm reaches
    # ~100, where 1e-6 is below one float32 ulp: 1e-6 of the frame's scale
    tol = TOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=0)


def test_hsv_to_rgb_matches_jax_on_every_sector():
    rng = np.random.default_rng(3)
    h = rng.random(600).astype(np.float32)
    h[:7] = [0.0, 1 / 6, 2 / 6, 0.5, 4 / 6, 5 / 6, 1.0]  # sector edges and h == 1
    s, v = rng.random(600).astype(np.float32), rng.random(600).astype(np.float32)
    got = viz._hsv_to_rgb(*(torch.from_numpy(a) for a in (h, s, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jviz._hsv_to_rgb(h, s, v)),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("vis", [0, 1, 2, 3])
def test_nan_cell_renders_nan_where_jax_does(vis):
    fields = _fields()
    for name in ("v", "p", "dye"):
        fields[name][..., 9, 7] = np.nan
    jstate, jcfg, tstate, cfg = _states("float32", fields)
    got = viz.render_rgb(tstate, T_SCENE, cfg, vis).numpy()
    ref = np.asarray(jviz.render_rgb(jstate, JAX_SCENE, jcfg, vis))
    assert np.isnan(ref).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(got[ok], ref[ok], atol=TOL, rtol=0)


@pytest.mark.parametrize("vis", [0, 1, 2, 3])
def test_to_image_matches_jax(vis):
    jstate, jcfg, tstate, cfg = _states("float32")
    got = viz.to_image(viz.render_rgb(tstate, T_SCENE, cfg, vis))
    ref = jviz.to_image(jviz.render_rgb(jstate, JAX_SCENE, jcfg, vis))
    assert got.dtype == np.uint8 and got.shape == ref.shape == (RES, 2 * RES, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_to_image_orientation():
    """(X, Y) grid → screen image: row 0 at the top is max y, x runs right."""
    rgb = torch.zeros((4, 3, 3))
    rgb[0, 2] = 1.0  # x=0, y=max
    img = viz.to_image(rgb)
    assert img.shape == (3, 4, 3)
    assert (img[0, 0] == 255).all()
    np.testing.assert_array_equal(img, jviz.to_image(rgb.numpy()))


@pytest.mark.parametrize("vis", [0, 1, 2, 3])
def test_walls_painted(vis):
    _, _, tstate, cfg = _states("float32")
    rgb = viz.render_rgb(tstate, T_SCENE, cfg, vis).numpy()
    wall = T_SCENE.wall.numpy()
    assert wall.any()
    np.testing.assert_array_equal(rgb[wall], np.tile(np.float32(viz.WALL_COLOR), (wall.sum(), 1)))


def test_vis_by_name():
    _, _, tstate, cfg = _states("float32")
    for k, name in enumerate(viz.VIS_MODES):
        assert torch.equal(viz.render_rgb(tstate, T_SCENE, cfg, name),
                           viz.render_rgb(tstate, T_SCENE, cfg, k))


def test_render_errors_match_jax():
    jstate, jcfg, tstate, cfg = _states("float32", enable_dye=False)
    for render, st, c, sc in ((viz.render_rgb, tstate, cfg, T_SCENE),
                              (jviz.render_rgb, jstate, jcfg, JAX_SCENE)):
        with pytest.raises(ValueError, match="dye visualization requires enable_dye=True"):
            render(st, sc, c, 3)
        with pytest.raises(ValueError, match="Unknown visualization mode: 4"):
            render(st, sc, c, 4)
