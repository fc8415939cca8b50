"""The kk800 configuration and its cell kk800.run: found by name, its
reader of the KK phases' device time, the plain reference against the
program's eager path under its settings, and a whole run on the CPU at a
tiny size."""

from __future__ import annotations

import pytest
import torch

from bench_port import registry, run
from bench_port.reference import scenes
from bench_port.reference.step import Reference
from bench_port.seeded import seeded_state
from bench_port.session import sim_config
from bench_port.tests.conftest import shrink, tiny_copy
from fluid2d_tpu_torch.config import SimConfig
from fluid2d_tpu_torch.models.simulator import FluidSimulator
from fluid2d_tpu_torch.scenes.compile import get_scene
from fluid2d_tpu_torch.state import SimState

SEED = 2**31 + 1694163845  # more than 32 signed bits hold


def test_registry_finds_kk800_and_its_cell(bench):
    cell = registry.cell(bench, "kk800.run")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("kk800", "run", 1)
    cfg = registry.config("kk800")
    entry = next(c for c in bench["configs"] if c["name"] == "kk800")
    assert entry["file"] == "bench_port/configs/kk800.json" and entry["reduced"] == []
    assert (cfg["scene"], cfg["resolution"], cfg["scheme"], cfg["re"]) == (2, 800, "kk", 1000.0)
    assert cfg["dt"] == pytest.approx(0.0125 / 800, rel=1e-12) and "dt" in cfg["assumed"]
    assert (cfg["vor_eps"], cfg["enable_dye"], cfg["pressure_solver"], cfg["sor_omega"],
            cfg["n_pressure_iter"], cfg["velocity_limit"], cfg["dtype"]) == (
        5.0, True, "sor", 1.3, 2, 10.0, "float32")
    assert registry.limits("kk800.run")["nonfinite"] == 0
    plain = {m["name"] for m in registry.metrics_for(bench, "kk800.run", False)}
    traced = {m["name"] for m in registry.metrics_for(bench, "kk800.run", True)}
    assert plain == {"steps_per_s.host_bound", "setup_s"}
    assert traced == {"host_us_per_step.host_bound", "device_idle_pct.host_bound",
                      "step_roofline.host_bound", "kk_phase_us.host_bound"}
    for name in traced:
        assert callable(registry.reader(name))


def _record(ops, steps=400, counts="steps"):
    return {"counts": counts, "trace": {"steps": steps, "device_ops": ops}}


def test_kk_phase_reader_takes_only_the_kk_forms():
    read = registry.reader("kk_phase_us.host_bound")
    ops = [
        ["(anonymous namespace)::sor_fused_kernel<float, float, float, 2>", 0.020],
        ["(anonymous namespace)::mac_velocity_fused_kernel<float, true, 32, 32>", 0.012],
        ["(anonymous namespace)::mac_dye_fused_kernel<float, true, 32, 32>", 0.008],
        ["(anonymous namespace)::mac_velocity_fused_kernel<float, false, 32, 32>", 0.5],
        ["(anonymous namespace)::mac_dye_fused_kernel<__nv_bfloat16, false, 32, 32>", 0.5],
        ["(anonymous namespace)::confinement_fused_kernel<float, 16, 32>", 0.006],
        ["Memcpy DtoH (Device -> Pageable)", 1e-6],
    ]
    assert read(_record(ops)) == pytest.approx(1e6 * 0.020 / 400)
    bf16 = [["(anonymous namespace)::mac_dye_fused_kernel<__nv_bfloat16, true, 32, 32>", 0.004]]
    assert read(_record(bf16, steps=100)) == pytest.approx(40.0)


def test_kk_phase_reader_gives_none_where_there_is_nothing_to_read():
    read = registry.reader("kk_phase_us.host_bound")
    upwind = [["(anonymous namespace)::mac_velocity_fused_kernel<float, false, 32, 32>", 0.01],
              ["(anonymous namespace)::mac_dye_fused_kernel<float, false, 32, 32>", 0.01],
              ["(anonymous namespace)::sor_fused_kernel<float, float, float, 2>", 0.02]]
    assert read(_record(upwind)) is None
    assert read(_record([])) is None
    kk = [["(anonymous namespace)::mac_velocity_fused_kernel<float, true, 32, 32>", 0.01]]
    assert read(_record(kk, counts="calls")) is None  # a frame loop
    assert read(_record(kk, steps=0)) is None
    assert read({"counts": "steps"}) is None  # an untraced run


@pytest.mark.parametrize("res", [20, 32])
def test_kk800_steps_match_the_eager_path(res):
    """kk800's settings at a CPU size: 100 steps of the program's eager path
    from the seeded state bit-equal to the plain reference's."""
    cfg = {**registry.config("kk800"), "resolution": res, "dt": 0.0125 / res}
    sc = sim_config(cfg)
    drawn = scenes.draw(2, res)
    ref = Reference(sc, {**drawn, **scenes.derive(drawn["mask"])}, "cpu")
    s0 = seeded_state(sc, ref.fluid, SEED, cfg["initial_speed"])
    prog_cfg = SimConfig.create(kernels="eager", **{k: v for k, v in sc.items() if k != "dx"})
    sim = FluidSimulator(get_scene(2, res, "cpu"), prog_cfg,
                         state=SimState(**{k: v.clone() for k, v in s0.items()}))
    sim.step(100)
    s100 = ref.run(s0, 100)
    assert int(s100["step"]) == 100
    for name, leaf in zip(sim.state._fields, sim.state):
        if leaf is not None:
            assert bool(torch.isfinite(leaf).all()), name
            assert torch.equal(leaf, s100[name]), name
    assert set(s100) == {n for n, leaf in zip(sim.state._fields, sim.state) if leaf is not None}


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_kk800_run_is_correct(bench, tmp_path, traced):
    root = tiny_copy(tmp_path)
    shrink(root, {"kk800": 16})
    r = run.run_cell(bench, registry.cell(bench, "kk800.run"), SEED, 0.2, traced, "cpu",
                     root=root)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] % 6 == 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    wanted = {m["name"] for m in registry.metrics_for(bench, "kk800.run", traced)}
    # the CPU has no device trace: the roofline and KK-phase readers find nothing
    assert set(r["metrics"]) == wanted - {"step_roofline.host_bound", "kk_phase_us.host_bound"}
