"""Residual-matched Jacobi-vs-SOR comparison (port of
``scripts/solver_residual_bench.py``).

Comparing the two pressure solvers at equal n_iter is iteration-matched,
not accuracy-matched: one red-black SOR pair (ω=1.3,
``fs/pressure_updater.py:70-114``) converges faster per iteration than one
Jacobi ping-pong (``fs/pressure_updater.py:42-66``). This script sweeps
n_pressure_iter for both solvers at the headline config (scene 2, CIP,
dye, ε=5) and reports, per (solver, n_iter), the settled post-step RMS
divergence over fluid cells (what the pressure projection drives down)
and the steps/s, so the comparison reads "steps/s at equal residual".

Method: run `--settle` steps from the cold start, average the RMS
divergence over the next `--probe` two-step runs, then time `--steps`
steps after a warm-up run of the same length (``utils/profiling.py
time_steps``: ended by a synchronize and a device→host read).

    python -m fluid2d_tpu_torch.scripts.solver_residual_bench
        [--res 1600] [--iters 1,2,3,4,6] [--settle 400] [--probe 10] [--steps 200]
        [--device cuda]

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain versions (a check of the script, not a measurement).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fluid2d_tpu_torch.config import SimConfig, resolve_device
from fluid2d_tpu_torch.models.simulator import make_run_fn, scene_for_dtype
from fluid2d_tpu_torch.scenes.compile import get_scene
from fluid2d_tpu_torch.state import init_state
from fluid2d_tpu_torch.utils.metrics import divergence
from fluid2d_tpu_torch.utils.profiling import device_name, time_steps

__all__ = ["make_cfg", "div_rms", "run_one", "main"]


def make_cfg(res, solver, n_iter):
    return SimConfig.create(
        resolution=res, re=1_000_000.0, scheme="cip", vor_eps=5.0,
        enable_dye=True, pressure_solver=solver, n_pressure_iter=n_iter,
    )


def div_rms(state, scene, cfg) -> float:
    """Post-step RMS divergence over the fluid cells (float32)."""
    d = torch.where(scene.fluid, divergence(state.v.float(), cfg.dx), 0.0)
    return float(torch.sqrt((d**2).sum() / scene.fluid.sum()))


def run_one(res, solver, n_iter, settle, probe, steps, bc=2, device="cuda"):
    """(mean RMS divergence over `probe` two-step runs after `settle`
    steps, timed steps/s) for one solver and iteration count."""
    cfg = make_cfg(res, solver, n_iter)
    scene = scene_for_dtype(get_scene(bc, res, resolve_device(device)), cfg)
    state = init_state(scene, cfg, scene.mask.device)
    run = make_run_fn(cfg)

    state = run(state, scene, settle)
    resid = []
    for _ in range(probe):
        state = run(state, scene, 2)  # keep the 2-step parity
        resid.append(div_rms(state, scene, cfg))
    sec_per_step, _ = time_steps(run, state, scene, steps)
    return float(np.mean(resid)), 1.0 / sec_per_step


def main(argv: list[str] | None = None) -> list[tuple[str, int, float, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=1600)
    ap.add_argument("--iters", type=str, default="1,2,3,4,6")
    ap.add_argument("--settle", type=int, default=400)
    ap.add_argument("--probe", type=int, default=10)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    iters = [int(s) for s in args.iters.split(",")]
    dev = resolve_device(args.device)

    print(f"device: {device_name(dev)}  res={args.res}")
    rows = []
    for solver in ("sor", "jacobi"):
        for n in iters:
            resid, rate = run_one(args.res, solver, n, args.settle, args.probe, args.steps,
                                  device=dev)
            rows.append((solver, n, resid, rate))
            print(f"{solver:6s} n_iter={n}: div_rms={resid:.4e}  "
                  f"{rate:7.1f} steps/s", flush=True)
    print("\n| solver | n_iter | RMS divergence | steps/s |")
    print("|---|---|---|---|")
    for solver, n, resid, rate in rows:
        print(f"| {solver} | {n} | {resid:.3e} | {rate:.1f} |")
    return rows


if __name__ == "__main__":
    main()
