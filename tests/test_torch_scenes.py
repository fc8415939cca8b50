"""The port's scenes against the JAX package's: every Scene leaf of all
six built-in scenes (and an image-mask scene) is array-equal, and the
NumPy exchange format round-trips exactly."""

import numpy as np
import pytest
import torch

from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
from fluid2d_tpu_torch.convert import scene_from_numpy
from fluid2d_tpu_torch.scenes.compile import Scene, get_scene

torch.set_num_threads(1)


def _jax_leaves(scene) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in zip(scene._fields, scene)}


def _assert_scene_equal(got: Scene, ref: dict[str, np.ndarray]) -> None:
    assert Scene._fields == tuple(ref)
    for name in Scene._fields:
        leaf = getattr(got, name)
        assert leaf.is_contiguous(), name
        a = leaf.cpu().numpy()
        assert a.dtype == ref[name].dtype, f"{name}: {a.dtype} != {ref[name].dtype}"
        np.testing.assert_array_equal(a, ref[name], err_msg=name)


@pytest.mark.parametrize("res", [16, 32])
@pytest.mark.parametrize("num", [1, 2, 3, 4, 5, 6])
def test_scene_leaves_equal_jax(num, res):
    got = get_scene(num, res, "cpu")
    assert got.shape == (2 * res, res)
    _assert_scene_equal(got, _jax_leaves(jax_get_scene(num, res)))


def test_mask_image_scene_equals_jax():
    got = get_scene(1, 24, "cpu", mask_image="rabbit")
    _assert_scene_equal(got, _jax_leaves(jax_get_scene(1, 24, mask_image="rabbit")))


def test_scene_from_numpy_round_trips():
    ref = _jax_leaves(jax_get_scene(2, 16))
    _assert_scene_equal(scene_from_numpy(ref, "cpu"), ref)
    with pytest.raises(KeyError, match="fluid8"):
        scene_from_numpy({k: v for k, v in ref.items() if k != "fluid8"}, "cpu")


def test_unknown_scene_raises():
    with pytest.raises(ValueError, match="valid: 1..6"):
        get_scene(7, 16, "cpu")
