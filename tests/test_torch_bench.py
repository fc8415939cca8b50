"""The port's bench entry point (fluid2d_tpu_torch/bench.py) on the CPU:

* its presets are the root bench.py's, step counts included (the root file
  is loaded from its path; its module level imports no JAX);
* ``bench_config`` runs every scheme and gives a finite rate;
* its final state after the warm-up and the timed run (2n steps from the
  zero state, through the kernel wrappers, which take their plain versions
  on the CPU) matches the JAX package's
  ``make_run_fn(kernels="xla")`` over 2n steps on every leaf within
  2e-5·max(1, |ref|max), the multi-step tolerance of tests/test_torch_step.py.
  Confinement is off and the CIP run is 2 steps: the impulsive start from
  the zero state leaves exact zeros where the confinement's 0/0 → +0.1 rule
  and CIP's upwind choice switch on one-ulp noise (docs/PARITY.md §4), so
  later steps differ by up to dt·ε·0.1 in v, and the JAX package's own xla
  and Pallas paths by 2.9e-3·|vy|max after 6 CIP steps. One step from the
  same state agrees to 2.3e-7 (tests/test_torch_step.py holds the seeded
  state, confinement on, to the JAX package over 4 steps);
* ``run_preset`` reports a stable row, the command line refuses a missing
  card (at bf16 too) and runs bf16 on the CPU with the metric's ``_bfloat16``
  suffix, and ``python -m fluid2d_tpu_torch.bench --device cpu`` prints one
  JSON line without importing JAX.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fluid2d_tpu.config import SimConfig as JaxConfig
from fluid2d_tpu.models.simulator import make_run_fn as jax_make_run_fn
from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
from fluid2d_tpu.state import init_state as jax_init_state
from fluid2d_tpu_torch import bench
from fluid2d_tpu_torch.convert import state_to_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RES = 32
TOL = 2e-5


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_presets_match_root_bench():
    assert bench._PRESETS == _root_bench()._PRESETS


@pytest.mark.parametrize("scheme", ["upwind", "kk", "cip"])
def test_bench_config_gives_a_finite_rate(scheme):
    rate, state = bench.bench_config(RES, scheme, 2, device="cpu")
    assert np.isfinite(rate) and rate > 0
    assert int(state.step) == 4
    assert bool(torch.isfinite(state.v).all())


@pytest.mark.parametrize(("scheme", "n"), [("upwind", 3), ("kk", 3), ("cip", 1)])
def test_bench_config_eager_state_matches_jax(scheme, n):
    _, state = bench.bench_config(RES, scheme, n, device="cpu", vor_eps=None)
    jcfg = JaxConfig.create(resolution=RES, scheme=scheme, vor_eps=None, kernels="xla")
    jscene = jax_get_scene(2, RES)
    ref_state = jax_make_run_fn(jcfg)(jax_init_state(jscene, jcfg), jscene, 2 * n)
    ref = {k: np.asarray(v) for k, v in zip(ref_state._fields, ref_state) if v is not None}
    got = state_to_numpy(state)
    assert set(got) == set(ref) and int(ref["step"]) == 2 * n
    assert np.abs(ref["v"]).max() > 1e-3
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape and g.dtype == r.dtype, name
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=TOL * scale, rtol=0, err_msg=name)


def test_run_preset_reports_a_stable_row(monkeypatch):
    small = {n: {**p, "kw": {**p["kw"], "res": 16}, "steps": 2} for n, p in bench._PRESETS.items()}
    monkeypatch.setattr(bench, "_PRESETS", small)
    for n in (1, 3):
        row = bench.run_preset(n, device="cpu")
        assert row["metric"] == f"baseline_config_{n}" and row["unit"] == "steps/s"
        assert row["stable"] is True and row["value"] > 0 and row["device"] == "cpu"
        assert "vs_baseline" not in row


def test_cli_refuses_a_missing_card_and_bf16(monkeypatch, capsys):
    """Without a card the bench refuses, at bf16 as at float32: bf16 does not
    fall back to the CPU either. With --device cpu it runs bf16."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.main(["--res", "16", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.bench_config(16, "cip", 1, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.main(["--res", "16", "--steps", "1", "--dtype", "bfloat16"])
    bench.main(["--device", "cpu", "--res", "16", "--steps", "1", "--dtype", "bfloat16"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "steps_per_sec_res16_cip_bfloat16" and row["value"] > 0


@pytest.mark.parametrize("scheme", ["upwind", "kk", "cip"])
def test_bench_config_runs_bf16(scheme):
    rate, state = bench.bench_config(RES, scheme, 2, dtype="bfloat16", device="cpu")
    assert np.isfinite(rate) and rate > 0
    assert state.v.dtype == torch.bfloat16 and state.p.dtype == torch.bfloat16
    assert bool(torch.isfinite(state.v.float()).all())


def test_run_preset_bf16_metric(monkeypatch):
    small = {n: {**p, "kw": {**p["kw"], "res": 16}, "steps": 2} for n, p in bench._PRESETS.items()}
    monkeypatch.setattr(bench, "_PRESETS", small)
    row = bench.run_preset(2, dtype="bfloat16", device="cpu")
    assert row["metric"] == "baseline_config_2_bfloat16" and row["stable"] is True


def test_module_prints_one_json_line_without_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['bench', '--device', 'cpu', '--res', '32', '--steps', '4']\n"
        "runpy.run_module('fluid2d_tpu_torch.bench', run_name='__main__')\n"
        "import fluid2d_tpu_torch.scripts.vpu_rate_sweep, fluid2d_tpu_torch.scripts.dma_geometry_sweep\n"
        "import fluid2d_tpu_torch.scripts.dma_geometry_bench\n"
        "import fluid2d_tpu_torch.scripts.dma_rowwin_1600_check\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fluid2d_tpu.')))\n"
        "print('imported:', bad, file=sys.stderr)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=False)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    row = json.loads(lines[0])
    assert {"metric", "value", "unit"} <= set(row) and "vs_baseline" not in row
    assert row["metric"] == "steps_per_sec_res32_cip" and row["unit"] == "steps/s"
    assert row["value"] > 0 and row["device"] == "cpu"
