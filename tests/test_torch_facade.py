"""The port's whole ``FluidSimulator`` on the CPU (mirror of
tests/test_simulator.py): the four views, the dump layout, the checkpoint
round trip and resumed stepping, the bc override that discards a stored
mask image with its note, reset, screenshot, and a no-dye simulator
refusing vis 3; the device rules (the card by default, raising without
one). And the diagnostics (``utils/metrics.py``) against the JAX
package's on one seeded state: ``divergence`` within 1e-6·max|ref|,
``diagnostics``' numbers within 1e-5 relative in the same format, and
``has_nan``."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from fluid2d_tpu.utils import metrics as jmetrics
from fluid2d_tpu_torch import FluidSimulator, SimState
from fluid2d_tpu_torch.convert import scene_from_numpy, state_from_numpy
from fluid2d_tpu_torch.utils import metrics
from fluid2d_tpu_torch.utils.viz import WALL_COLOR

from tests.torch_seeded import jax_seeded_state, leaves_np

torch.set_num_threads(1)

RES = 24


@pytest.fixture(scope="module")
def sim():
    s = FluidSimulator.create(1, RES, re=100.0, scheme="cip", enable_dye=True, device="cpu")
    s.step(5)
    return s


def test_render_modes(sim):
    for getter in (sim.get_norm_field, sim.get_pressure_field,
                   sim.get_vorticity_field, sim.get_dye_field):
        rgb = getter()
        assert isinstance(rgb, np.ndarray) and rgb.dtype == np.float32
        assert rgb.shape == (2 * RES, RES, 3)
        assert np.isfinite(rgb).all()
    wall = sim.scene.wall.numpy()
    rgb = sim.get_norm_field()
    np.testing.assert_allclose(rgb[wall], np.tile(np.float32(WALL_COLOR), (wall.sum(), 1)),
                               atol=1e-6)
    for vis in range(4):
        frame = sim.render(vis)
        assert frame.device == sim.state.v.device and frame.dtype == torch.float32
        assert torch.equal(frame, sim._render(sim.state, sim.scene, vis))


def test_field_dump_layout(sim):
    fields = sim.field_to_numpy()
    assert fields["v"].shape == (2 * RES, RES, 2)
    assert fields["p"].shape == (2 * RES, RES)
    assert fields["dye"].shape == (2 * RES, RES, 3)


def test_checkpoint_roundtrip(tmp_path: Path, sim):
    path = tmp_path / "ckpt.npz"
    sim.save(path)
    restored = FluidSimulator.load(path, bc_num=1, device="cpu")
    assert restored.step_count == sim.step_count == 5
    assert restored.cfg == sim.cfg and restored.scene_meta == {"bc_num": 1, "mask_image": None}
    for name, a, b in zip(SimState._fields, sim.state, restored.state):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    # resumed stepping continues identically
    sim2 = FluidSimulator.load(path, bc_num=1, device="cpu")
    sim2.step(3)
    restored.step(3)
    assert sim2.step_count == 8
    assert torch.equal(sim2.state.v, restored.state.v)


def test_resume_equals_straight_run(tmp_path: Path):
    """5 + 4 steps through a checkpoint equal 9 straight steps, every leaf."""
    a = FluidSimulator.create(2, RES, device="cpu")
    a.step(5)
    a.save(tmp_path / "a.npz")
    b = FluidSimulator.load(tmp_path / "a.npz", device="cpu")
    b.step(4)
    c = FluidSimulator.create(2, RES, device="cpu")
    c.step(9)
    for name, x, y in zip(SimState._fields, b.state, c.state):
        if x is not None:
            assert torch.equal(x, y), name


def test_load_bc_override_replaces_stored_mask_scene(tmp_path: Path, capsys):
    sim = FluidSimulator.create(1, 36, re=100.0, mask_image="dragon", device="cpu")
    path = tmp_path / "ckpt.npz"
    sim.save(path)
    capsys.readouterr()

    restored = FluidSimulator.load(path, bc_num=2, device="cpu")
    out = capsys.readouterr().out
    assert "note: -bc 2 overrides the checkpoint's scene" in out
    assert "discarded" in out and "dragon" in out
    assert restored.scene_meta == {"bc_num": 2, "mask_image": None}
    assert not torch.equal(restored.scene.mask, sim.scene.mask)
    # Without an override the stored identity (dragon) is restored, silently.
    inherited = FluidSimulator.load(path, device="cpu")
    assert "discarded" not in capsys.readouterr().out
    assert inherited.scene_meta["mask_image"] == "dragon"
    assert torch.equal(inherited.scene.mask, sim.scene.mask)


def test_reset():
    s = FluidSimulator.create(1, RES, re=100.0, scheme="upwind", enable_dye=False,
                              device="cpu")
    s.step(3)
    assert float(s.state.v.abs().max()) > 0
    s.reset()
    assert s.step_count == 0
    assert float(s.state.v.abs().max()) == 0


def test_screenshot(tmp_path: Path, sim):
    out = tmp_path / "shot.png"
    sim.screenshot(out, vis=0)
    with Image.open(out) as im:
        assert im.size == (2 * RES, RES)  # (W=X, H=Y) in screen orientation


def test_no_dye_simulator_rejects_dye_vis():
    s = FluidSimulator.create(1, RES, enable_dye=False, scheme="upwind", device="cpu")
    with pytest.raises(ValueError, match="dye"):
        s.get_dye_field()


def test_given_state_is_recast_to_the_transport_dtype(sim):
    s = FluidSimulator(sim.scene, dataclasses.replace(sim.cfg, dtype="bfloat16"),
                       state=sim.state, scene_meta=sim.scene_meta)
    assert s.state.v.dtype == torch.bfloat16 and s.state.step.dtype == torch.int32
    assert s.scene.bc_const.dtype == torch.bfloat16 and s.device == torch.device("cpu")
    s.step(1)
    assert s.step_count == 6


def test_card_is_the_default_and_raises_without_one(tmp_path: Path, sim):
    if torch.cuda.is_available():
        pytest.skip("checks the card-less refusal")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        FluidSimulator.create(2, 16)
    sim.save(tmp_path / "a.npz")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        FluidSimulator.load(tmp_path / "a.npz")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        FluidSimulator(sim.scene, sim.cfg, device="cuda")


# --- diagnostics against the JAX package --------------------------------------

@pytest.fixture(scope="module")
def seeded():
    jst, jscene, jcfg = jax_seeded_state(RES)
    scene = scene_from_numpy({k: np.asarray(v) for k, v in zip(jscene._fields, jscene)}, "cpu")
    return jst, jscene, jcfg, state_from_numpy(leaves_np(jst), "cpu"), scene


def test_divergence_matches_jax(seeded):
    jst, _, jcfg, state, _ = seeded
    ref = np.asarray(jmetrics.divergence(jst.v, jcfg.dx))
    got = metrics.divergence(state.v, jcfg.dx).numpy()
    assert got.shape == (2 * RES, RES)
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


def _numbers(diag: str) -> list[float]:
    m = re.fullmatch(r"div_rms=(\S+) max\|v\|=(\S+) max\|p\|=(\S+)(  \*\* NaN DETECTED \*\*)?",
                     diag)
    assert m, diag
    return [float(x) for x in m.groups()[:3]] + [m.group(4) is not None]


@pytest.mark.parametrize("nan", [False, True])
def test_diagnostics_match_jax(seeded, nan):
    jst, jscene, jcfg, state, scene = seeded
    if nan:
        v = jst.v.at[0, 5, 5].set(np.nan)
        jst = jst._replace(v=v)
        state = state._replace(v=torch.from_numpy(np.array(v)))
    got, ref = metrics.diagnostics(state, scene, jcfg), jmetrics.diagnostics(jst, jscene, jcfg)
    g, r = _numbers(got), _numbers(ref)
    assert g[3] == r[3] == nan
    if not nan:
        np.testing.assert_allclose(g[:3], r[:3], rtol=1e-5)
        assert got.startswith("div_rms=") and r[0] > 0


@pytest.mark.parametrize("field", ["v", "p", "dye", None])
def test_has_nan_matches_jax(seeded, field):
    jst, _, _, state, _ = seeded
    if field is not None:
        a = np.array(getattr(state, field))
        a.reshape(-1)[7] = np.nan
        state = state._replace(**{field: torch.from_numpy(a)})
        jst = jst._replace(**{field: a})
    assert metrics.has_nan(state) is jmetrics.has_nan(jst) is (field is not None)


def test_bf16_diagnostics_are_float32(seeded):
    _, _, jcfg, state, scene = seeded
    bf = state._replace(v=state.v.bfloat16(), p=state.p.bfloat16())
    d32 = _numbers(metrics.diagnostics(bf._replace(v=bf.v.float(), p=bf.p.float()), scene, jcfg))
    assert _numbers(metrics.diagnostics(bf, scene, jcfg)) == d32
