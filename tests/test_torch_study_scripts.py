"""The port's study scripts on the CPU at res=32 with few steps:
``solver_residual_bench`` (its rows and table, finite, its RMS divergence
equal to the one ``utils.metrics.divergence`` and ``diagnostics`` give on
the same state) and ``bf16_drift`` (its JSON line: the geometric schedule
of the JAX script, every error finite, no NaN); both raise without a card
at their default device."""

import json

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch import FluidSimulator
from fluid2d_tpu_torch.scripts import bf16_drift, solver_residual_bench
from fluid2d_tpu_torch.utils.metrics import diagnostics, divergence

torch.set_num_threads(1)


def test_solver_residual_bench_rows_and_table(capsys):
    rows = solver_residual_bench.main(["--res", "32", "--iters", "2,4", "--settle", "6",
                                       "--probe", "2", "--steps", "2", "--device", "cpu"])
    assert [(s, n) for s, n, _, _ in rows] == [("sor", 2), ("sor", 4), ("jacobi", 2),
                                             ("jacobi", 4)]
    for _, _, resid, rate in rows:
        assert np.isfinite(resid) and resid > 0 and np.isfinite(rate) and rate > 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu  res=32")
    assert "| solver | n_iter | RMS divergence | steps/s |" in out
    assert out.count("\n| sor |") == 2 and out.count("\n| jacobi |") == 2


def test_solver_residual_divergence_is_the_metrics_one():
    sim = FluidSimulator.create(2, 32, device="cpu")
    sim.step(6)
    got = solver_residual_bench.div_rms(sim.state, sim.scene, sim.cfg)
    d = divergence(sim.state.v, sim.cfg.dx).numpy()
    fluid = sim.scene.fluid.numpy()
    want = float(np.sqrt((d[fluid].astype(np.float64) ** 2).mean()))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    diag = float(diagnostics(sim.state, sim.scene, sim.cfg).split()[0].removeprefix("div_rms="))
    np.testing.assert_allclose(got, diag, rtol=1e-3)  # printed to 4 digits


def test_bf16_drift_json_line(capsys):
    out = bf16_drift.main(["--res", "32", "--steps", "20", "--points", "3", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert (out["res"], out["bc"], out["scheme"], out["backend"]) == (32, 2, "cip", "cpu")
    assert [row["step"] for row in out["drift"]] == [1, 4, 18, 20]
    for row in out["drift"]:
        for name in ("v", "p", "dye"):
            assert 0 <= row[f"{name}_max"] < 0.5 and np.isfinite(row[f"{name}_rms"])
        assert row["f32_div_rms"] > 0 and row["bf16_nan"] is False
    assert out["drift"][-1]["v_max"] > 0  # bf16 does drift


@pytest.mark.parametrize(("steps", "points"), [(200, 6), (2000, 6), (20, 3), (5, 2)])
def test_bf16_drift_schedule_is_the_jax_scripts(steps, points):
    marks, m = [], 1  # scripts/bf16_drift.py's loop, verbatim
    while m < steps:
        marks.append(m)
        m = max(m + 1, int(round(m * (steps ** (1 / (points - 1))))))
    marks.append(steps)
    assert bf16_drift.marks_for(steps, points) == marks


def test_scripts_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the card-less refusal")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        solver_residual_bench.main(["--res", "16", "--iters", "2"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bf16_drift.main(["--res", "16", "--steps", "2"])
