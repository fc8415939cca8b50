"""The port's checkpoints and image output (``fluid2d_tpu_torch/utils/io.py``)
against the JAX package's (``fluid2d_tpu/utils/io.py``).

A port round trip is bit-exact on every leaf at float32 and bf16. The
files cross both ways, bit for bit at float32 and bf16: a JAX checkpoint
resumes in the port, a port checkpoint resumes in the JAX package
(``kernels="xla"``), and each resumed 4-step float32 run keeps every leaf
within 2e-5·max|field| of a run that never left its package. The two
writers produce the same leaves and the same ``__config__`` bytes; the
kernels names map both ways; suffix-less
(orbax) and unknown-suffix paths raise; the PNG decodes to the JAX
writer's pixels; the GIF streams from paths."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from fluid2d_tpu.config import SimConfig as JaxConfig
from fluid2d_tpu.models.simulator import make_run_fn as jax_make_run_fn
from fluid2d_tpu.utils import io as jio
from fluid2d_tpu_torch import SimConfig, SimState, make_run_fn
from fluid2d_tpu_torch.convert import scene_from_numpy, state_from_numpy
from fluid2d_tpu_torch.utils import io as tio

from tests.torch_seeded import assert_close_to_scale, jax_seeded_state, leaves_np

torch.set_num_threads(1)

RES = 24
META = {"bc_num": 2, "mask_image": None}


def _t_scene(jscene, dtype="float32"):
    return scene_from_numpy({k: np.asarray(v) for k, v in zip(jscene._fields, jscene)},
                            "cpu", None if dtype == "float32" else dtype)


def _port_state(dtype="float32"):
    """The seeded state, one JAX step, carried into the port, plus two port steps."""
    jst, jscene, _ = jax_seeded_state(RES, dtype)
    cfg = SimConfig.create(resolution=RES, dtype=dtype)
    st = state_from_numpy(leaves_np(jst), "cpu", dtype)
    return make_run_fn(cfg)(st, _t_scene(jscene, dtype), 2), cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_round_trip_is_bit_exact(tmp_path, dtype):
    state, cfg = _port_state(dtype)
    path = tmp_path / "ck.npz"
    tio.save_checkpoint(path, state, cfg, META)
    back, cfg2, meta = tio.load_checkpoint(path, "cpu")
    assert cfg2 == cfg and meta == META
    for name, a, b in zip(SimState._fields, state, back):
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.dtype == a.dtype and b.device.type == "cpu", name
            assert torch.equal(a, b), name
    assert back.step.dtype == torch.int32 and int(back.step) == 3
    with np.load(path) as data:
        assert data["step"].dtype == np.int32 and data["step"].shape == ()
        assert data["v"].dtype == np.float32  # bf16 widened in the file


def test_jax_checkpoint_resumes_in_port(tmp_path):
    jst, jscene, jcfg = jax_seeded_state(RES)
    path = tmp_path / "jax.npz"
    jio.save_checkpoint(path, jst, jcfg, META)
    ref = leaves_np(jax_make_run_fn(jcfg)(jst, jscene, 4))

    state, cfg, meta = tio.load_checkpoint(path, "cpu")
    assert cfg.kernels == "eager" and meta == META and int(state.step) == 1
    got = leaves_np(make_run_fn(cfg)(state, _t_scene(jscene), 4))
    assert int(got["step"]) == 5
    assert_close_to_scale(got, ref)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    jst, jscene, _ = jax_seeded_state(RES)
    cfg = SimConfig.create(resolution=RES, kernels="eager")
    state = state_from_numpy(leaves_np(jst), "cpu")
    path = tmp_path / "port.npz"
    tio.save_checkpoint(path, state, cfg, META)
    ref = leaves_np(make_run_fn(cfg)(state, _t_scene(jscene), 4))

    jstate, jcfg, meta = jio.load_checkpoint(path)
    assert jcfg.kernels == "xla" and jcfg.sor_fuse == 1 and meta == META
    got = leaves_np(jax_make_run_fn(jcfg)(jstate, jscene, 4))
    assert int(got["step"]) == 5
    assert_close_to_scale(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_exactly(tmp_path, dtype):
    """What one package writes, the other loads bit for bit, in the
    transport dtype (bf16 runs of the two libraries part at rounding flips
    within a step, tests/test_torch_bf16.py, so the 4-step runs above are
    float32)."""
    jst, _, jcfg = jax_seeded_state(RES, dtype)
    jio.save_checkpoint(tmp_path / "j.npz", jst, jcfg, META)
    state, cfg, _ = tio.load_checkpoint(tmp_path / "j.npz", "cpu")
    assert state.v.dtype == getattr(torch, dtype) and cfg.dtype == dtype
    want = leaves_np(jst)
    got = leaves_np(state)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)

    tio.save_checkpoint(tmp_path / "t.npz", state, cfg, META)
    back, jcfg2, _ = jio.load_checkpoint(tmp_path / "t.npz")
    assert str(back.v.dtype) == dtype and jcfg2.dtype == dtype
    back = leaves_np(back)
    for name in want:
        np.testing.assert_array_equal(back[name], want[name], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_writers_agree_on_leaves_and_config_bytes(tmp_path, dtype):
    jst, _, _ = jax_seeded_state(RES, dtype)
    jcfg = JaxConfig.create(resolution=RES, dtype=dtype)
    cfg = SimConfig.create(resolution=RES, dtype=dtype)
    jio.save_checkpoint(tmp_path / "j.npz", jst, jcfg, META)
    tio.save_checkpoint(tmp_path / "t.npz", state_from_numpy(leaves_np(jst), "cpu", dtype),
                        cfg, META)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert j.files == t.files
        for name in j.files:
            assert j[name].dtype == t[name].dtype and j[name].shape == t[name].shape, name
            np.testing.assert_array_equal(t[name], j[name], err_msg=name)
        assert json.loads(t["__config__"].tobytes())["config"]["sor_fuse"] == 1


@pytest.mark.parametrize(("port", "jax"), [("auto", "auto"), ("cuda", "auto"),
                                           ("eager", "xla")])
def test_config_to_jax(port, jax):
    cfg = SimConfig.create(resolution=RES, kernels=port, vor_eps=None, dtype="bfloat16")
    fields = tio.config_to_jax(cfg)
    assert list(fields) == [f.name for f in JaxConfig.__dataclass_fields__.values()]
    jcfg = JaxConfig(**fields)
    assert jcfg.kernels == jax and jcfg.sor_fuse == 1
    assert JaxConfig.create(resolution=RES, vor_eps=None, dtype="bfloat16",
                            kernels=jax) == jcfg


@pytest.mark.parametrize(("jax", "port"), [("auto", "auto"), ("pallas", "auto"),
                                           ("pallas_interpret", "auto"), ("xla", "eager")])
def test_config_from_jax(jax, port):
    jcfg = JaxConfig.create(resolution=RES, kernels=jax, sor_fuse=2, scheme="kk")
    import dataclasses

    cfg = tio.config_from_jax(dataclasses.asdict(jcfg))
    assert cfg == SimConfig.create(resolution=RES, kernels=port, scheme="kk")


def test_config_from_jax_refuses_unknown_kernels():
    fields = tio.config_to_jax(SimConfig.create(resolution=RES)) | {"kernels": "bogus"}
    with pytest.raises(ValueError, match="kernels mode 'bogus'"):
        tio.config_from_jax(fields)


def test_suffixless_and_unknown_suffix_paths_raise(tmp_path):
    state, cfg = _port_state()
    with pytest.raises(ValueError, match="orbax.*JAX-only"):
        tio.save_checkpoint(tmp_path / "ckpt_dir", state, cfg)
    with pytest.raises(ValueError, match="orbax.*JAX-only"):
        tio.load_checkpoint(tmp_path / "ckpt_dir", "cpu")
    (tmp_path / "dir.v1").mkdir()  # a directory with a suffix is an orbax tree too
    with pytest.raises(ValueError, match="orbax.*JAX-only"):
        tio.load_checkpoint(tmp_path / "dir.v1", "cpu")
    with pytest.raises(ValueError, match="unrecognized checkpoint suffix '.ckpt'"):
        tio.save_checkpoint(tmp_path / "a.ckpt", state, cfg)
    assert not any(tmp_path.glob("ckpt_dir*")) and not (tmp_path / "a.ckpt").exists()
    tio.save_checkpoint(tmp_path / "upper.NPZ", state, cfg)  # any case of .npz


def test_load_onto_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    state, cfg = _port_state()
    tio.save_checkpoint(tmp_path / "a.npz", state, cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tio.load_checkpoint(tmp_path / "a.npz")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fields_to_numpy_layout(dtype):
    state, _ = _port_state(dtype)
    got = tio.fields_to_numpy(state)
    assert {k: (a.shape, a.dtype) for k, a in got.items()} == {
        "v": ((2 * RES, RES, 2), np.float32), "p": ((2 * RES, RES), np.float32),
        "dye": ((2 * RES, RES, 3), np.float32)}
    np.testing.assert_array_equal(got["v"][..., 1], state.v[1].float().numpy())
    np.testing.assert_array_equal(got["dye"][..., 2], state.dye[2].float().numpy())
    assert "dye" not in tio.fields_to_numpy(state._replace(dye=None))


def test_png_matches_jax_writer(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (24, 48, 3), dtype=np.uint8)
    tio.write_png(tmp_path / "sub" / "t.png", img)
    jio.write_png(tmp_path / "j.png", img)
    with Image.open(tmp_path / "sub" / "t.png") as t, Image.open(tmp_path / "j.png") as j:
        assert t.size == (48, 24) and t.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
        np.testing.assert_array_equal(np.asarray(t), img)


def test_write_gif_streams_from_paths(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.png"
        tio.write_png(p, rng.integers(0, 255, (8, 8, 3), dtype=np.uint8))
        paths.append(p)
    opened = []

    def lazy():  # the writer pulls one path at a time
        for p in paths:
            opened.append(p)
            yield p

    tio.write_gif(tmp_path / "out.gif", lazy())
    assert opened == paths
    with Image.open(tmp_path / "out.gif") as im:
        assert im.n_frames == 3
    tio.write_gif(tmp_path / "arr.gif",
                  [rng.integers(0, 255, (8, 8, 3), dtype=np.uint8) for _ in range(2)])
    with Image.open(tmp_path / "arr.gif") as im:
        assert im.n_frames == 2
