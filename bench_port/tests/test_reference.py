"""The plain reference against the program's eager path on the CPU: the
scenes cell for cell, and several steps of each scheme bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port.session import sim_config
from bench_port.reference import scenes
from bench_port.reference import view as ref_view
from bench_port.reference.step import Reference
from bench_port.seeded import seeded_state
from fluid2d_tpu_torch.config import SimConfig
from fluid2d_tpu_torch.models.simulator import FluidSimulator
from fluid2d_tpu_torch.scenes.compile import get_scene, scene_arrays
from fluid2d_tpu_torch.scenes.scenes import build_scene_arrays
from fluid2d_tpu_torch.state import SimState
from fluid2d_tpu_torch.utils.viz import to_image


@pytest.mark.parametrize("scene,res", [(1, 12), (1, 40), (2, 10), (2, 48)])
def test_scenes_match_the_programs(scene, res):
    prog = scene_arrays(*build_scene_arrays(scene, res))
    drawn = scenes.draw(scene, res)
    der = scenes.derive(drawn["mask"])
    np.testing.assert_array_equal(prog["mask"], drawn["mask"])
    np.testing.assert_array_equal(prog["bc_const"], drawn["bc"])
    np.testing.assert_array_equal(prog["bc_dye"], drawn["dye"])
    np.testing.assert_array_equal(prog["vbc_targets"], der["ghost"])
    np.testing.assert_array_equal(prog["pbc_code"], der["pcode"])
    np.testing.assert_array_equal(prog["odd_fluid"], der["odd_fluid"])


BASE = {"re": 1e6, "dt": None, "vor_eps": 5.0, "enable_dye": True, "pressure_solver": "sor",
        "sor_omega": 1.3, "n_pressure_iter": 2, "velocity_limit": 10.0, "dtype": "float32"}


@pytest.mark.parametrize("scene,res,over", [
    (2, 20, {"scheme": "cip"}),
    (1, 16, {"scheme": "upwind", "re": 1000.0, "dt": 5e-4, "vor_eps": None, "enable_dye": False}),
    (2, 20, {"scheme": "kk", "re": 1000.0}),
    (2, 20, {"scheme": "upwind", "pressure_solver": "jacobi", "n_pressure_iter": 6}),
    (1, 16, {"scheme": "cip", "n_pressure_iter": 3, "vor_eps": None}),
])
def test_steps_and_frame_match_the_eager_path(scene, res, over):
    cfg = {**BASE, "resolution": res, **over}
    sc = sim_config(cfg)
    drawn = scenes.draw(scene, res)
    ref = Reference(sc, {**drawn, **scenes.derive(drawn["mask"])}, "cpu")
    s0 = seeded_state(sc, ref.fluid, 2**33 + 5, 0.5)
    prog_cfg = SimConfig.create(kernels="eager", **{k: v for k, v in sc.items() if k != "dx"})
    sim = FluidSimulator(get_scene(scene, res, "cpu"), prog_cfg,
                         state=SimState(**{k: v.clone() for k, v in s0.items()}))
    sim.step(5)
    s5 = ref.run(s0, 5)
    for name, leaf in zip(sim.state._fields, sim.state):
        if leaf is not None:
            assert torch.equal(leaf, s5[name]), name
    assert set(s5) == {n for n, leaf in zip(sim.state._fields, sim.state) if leaf is not None}
    np.testing.assert_array_equal(to_image(sim.render(0)),
                                  ref_view.to_image(ref_view.render(s5, ref.wall, 0)))


def test_seeded_state_is_the_seeds():
    fluid = torch.as_tensor(scenes.draw(2, 10)["mask"] == 0)
    cfg = sim_config({**BASE, "resolution": 10, "scheme": "cip"})
    a, b = seeded_state(cfg, fluid, 7, 0.5), seeded_state(cfg, fluid, 7, 0.5)
    c = seeded_state(cfg, fluid, 2**40 + 7, 0.5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["v"], c["v"])
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in c.items()}
    assert float(a["v"].abs().max()) <= 0.5 and float(a["v"][:, ~fluid].abs().max()) == 0.0
    assert 0.1 <= float(a["dye"].min()) and float(a["dye"].max()) <= 0.9
