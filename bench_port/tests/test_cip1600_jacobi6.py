"""The cip1600_jacobi6 configuration and its cell cip1600_jacobi6.run: found
by name, its readers of the Jacobi kernel's device time and roofline share,
the solve's least bytes and element operations against hand counts, and a
whole run on the CPU at a tiny size."""

from __future__ import annotations

import numpy as np
import pytest

from bench_port import registry, run, solve_roofline
from bench_port.reference import scenes
from bench_port.session import sim_config
from bench_port.tests.conftest import shrink, tiny_copy

SEED = 2**31 + 1161279231  # more than 32 signed bits hold
CELL = "cip1600_jacobi6.run"

# x = 0 inflow; walls at (1, 0) and (2, 2); x = 3 outflow (roofline's MASK)
MASK = np.array([[2, 2, 2], [1, 0, 0], [0, 0, 1], [3, 3, 3]], np.uint8)
JACOBI = {"pressure_solver": "jacobi", "dtype": "float32"}


def test_registry_finds_cip1600_jacobi6_and_its_cell(bench):
    cell = registry.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("cip1600_jacobi6", "run", 1)
    cfg = registry.config("cip1600_jacobi6")
    entry = next(c for c in bench["configs"] if c["name"] == "cip1600_jacobi6")
    assert entry["file"] == "bench_port/configs/cip1600_jacobi6.json" and entry["reduced"] == []
    # cip1600's settings but the solve
    base = registry.config("cip1600")
    solve = {"pressure_solver", "n_pressure_iter"}
    for key in set(base) - solve - {"source", "assumed", "deployment"}:
        assert cfg[key] == base[key], key
    assert (cfg["pressure_solver"], cfg["n_pressure_iter"]) == ("jacobi", 6)
    assert solve <= set(cfg["assumed"])
    assert registry.limits(CELL)["nonfinite"] == 0
    plain = {m["name"] for m in registry.metrics_for(bench, CELL, False)}
    traced = {m["name"] for m in registry.metrics_for(bench, CELL, True)}
    assert plain == {"steps_per_s", "setup_s"}
    assert traced == {"host_us_per_step.run", "device_idle_pct.run", "step_roofline",
                      "jacobi_phase_us", "jacobi_roofline"}
    for name in traced:
        assert callable(registry.reader(name))
    # the new metrics belong to the new cell alone
    for other in ("cip1600.run", "kk800.run", "upwind400.run"):
        assert not {"jacobi_phase_us", "jacobi_roofline"} & {
            m["name"] for m in registry.metrics_for(bench, other, True)}


def _record(ops, steps=400, counts="steps", config=None):
    rec = {"counts": counts, "trace": {"steps": steps, "device_ops": ops},
           "root": str(registry.ROOT)}
    if config is not None:
        rec["config"] = config
    return rec


HEADLINE_OPS = [
    ["(anonymous namespace)::cip_velocity_fused_kernel<float, 32, 32>", 0.5],
    ["(anonymous namespace)::confinement_fused_kernel<float, 16, 32>", 0.1],
    ["(anonymous namespace)::sor_fused_kernel<float, float, float, 2>", 0.3],
    ["(anonymous namespace)::cip_dye_fused_kernel<float, 32, 32>", 0.7],
    ["Memcpy DtoH (Device -> Pageable)", 1e-6],
]


def test_jacobi_phase_reader_takes_every_jacobi_form_and_nothing_else():
    read = registry.reader("jacobi_phase_us")
    ops = [*HEADLINE_OPS,
           ["(anonymous namespace)::jacobi_fused_kernel<float, float, float, 4, 32, 32>", 0.08],
           ["(anonymous namespace)::jacobi_fused_kernel<float, float, float, 2, 32, 32>", 0.04]]
    assert read(_record(ops)) == pytest.approx(1e6 * 0.12 / 400)
    bf16 = [["(anonymous namespace)::jacobi_fused_kernel<__nv_bfloat16, float, "
             "__nv_bfloat16, 4, 32, 32>", 0.01]]
    assert read(_record(bf16, steps=100)) == pytest.approx(100.0)


def test_jacobi_readers_give_none_where_there_is_nothing_to_read():
    phase = registry.reader("jacobi_phase_us")
    share = registry.reader("jacobi_roofline")
    cfg = registry.config("cip1600_jacobi6")
    jac = [["(anonymous namespace)::jacobi_fused_kernel<float, float, float, 4, 32, 32>", 0.01]]
    for read in (phase, share):
        assert read(_record(HEADLINE_OPS, config=cfg)) is None  # SOR's step runs no Jacobi
        assert read(_record([], config=cfg)) is None
        assert read(_record(jac, counts="calls", config=cfg)) is None  # a frame loop
        assert read(_record(jac, steps=0, config=cfg)) is None
        assert read({"counts": "steps", "config": cfg}) is None  # an untraced run


def test_jacobi_roofline_is_the_least_solve_time_over_the_kernels_time():
    cfg = {**registry.config("cip1600_jacobi6"), "resolution": 16}
    drawn = scenes.draw(2, 16)
    least = solve_roofline.least_solve_s(sim_config(cfg),
                                         {**drawn, **scenes.derive(drawn["mask"])})["least_s"]
    secs = 1e4 * least  # a step's kernels at 1% of the least time, over 100 steps
    ops = [["(anonymous namespace)::jacobi_fused_kernel<float, float, float, 4, 32, 32>",
            0.75 * secs], ["(anonymous namespace)::jacobi_fused_kernel<float, float, float, 2, "
                           "32, 32>", 0.25 * secs], *HEADLINE_OPS]
    got = registry.reader("jacobi_roofline")(_record(ops, steps=100, config=cfg))
    assert got == pytest.approx(1.0)


def test_solve_bytes_by_hand():
    cells, wall = 12, 2
    reads = 3 * cells + wall  # p, u, w; p_alt at the walls
    writes = 4 * cells  # p, p_alt, the limited u, w
    assert solve_roofline.solve_bytes(JACOBI, MASK) == 4 * (reads + writes) + cells == 356
    bf16 = {**JACOBI, "dtype": "bfloat16"}
    assert solve_roofline.solve_bytes(bf16, MASK) == 2 * (reads + writes) + cells
    # SOR keeps p_alt off the odd fluid cells: 10 of the 12
    sor = {**JACOBI, "pressure_solver": "sor"}
    assert solve_roofline.solve_bytes(sor, MASK) == 4 * (3 * cells + 10 + writes) + cells


def _scene(mask):
    drawn = {"mask": mask, "bc": np.zeros((2, *mask.shape), np.float32),
             "dye": np.zeros((3, *mask.shape), np.float32)}
    return {**drawn, **scenes.derive(mask)}


@pytest.mark.parametrize("iters", [1, 2, 6])
def test_solve_elops_by_hand(iters):
    """A Jacobi iteration: the pressure BC 36 a cell (the four averages' adds
    and divisions 4 + 4·3, nine compares and selects 18, the Dirichlet code's
    compare and select 2), predict_p 23 (four differences, the neighbours'
    sum and quarter 4, the source's squares, sums and /8 8, the divergence
    term 5, the two combining 2), the select into the alternate 1; the
    limiter 17 (the norm 2 + 1 + sqrt 3, the compare 1, v / norm 2·3, the
    scaling 2, the select 2)."""
    cfg = {**JACOBI, "n_pressure_iter": iters, "sor_omega": 1.3, "velocity_limit": 10.0,
           "dt": 0.05 / 3, "dx": 1 / 3}
    assert solve_roofline.solve_elops(cfg, _scene(MASK)) == (60 * iters + 17) * MASK.size


def test_least_solve_time_takes_the_larger_bound():
    cfg = sim_config(registry.config("cip1600_jacobi6"))
    r = solve_roofline.least_solve_s({**cfg, "dx": 1 / 3}, _scene(MASK))
    assert r["bytes_s"] == r["bytes"] / 3.35e12 and r["elops_s"] == r["elops"] / 67e12
    assert r["least_s"] == max(r["bytes_s"], r["elops_s"])


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_cip1600_jacobi6_run_is_correct(bench, tmp_path, traced):
    root = tiny_copy(tmp_path)
    shrink(root, {"cip1600_jacobi6": 16})
    r = run.run_cell(bench, registry.cell(bench, CELL), SEED, 0.2, traced, "cpu", root=root)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] % 6 == 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    wanted = {m["name"] for m in registry.metrics_for(bench, CELL, traced)}
    # the CPU has no device trace: the roofline and Jacobi readers find nothing
    assert set(r["metrics"]) == wanted - {"step_roofline", "jacobi_phase_us", "jacobi_roofline"}
