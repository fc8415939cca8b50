"""How far does the bf16 transport trajectory drift from f32? (port of
``scripts/bf16_drift.py``)

The bfloat16 transport mode (SimConfig.dtype) rounds every phase output
to 8 mantissa bits. Fluid steps feed back — pressure reads velocity
divergence, advection reads everything — so the question a user of the
bf16 path has is the accumulated drift over a real horizon, not the
per-phase bound. This script runs the same scene from the zero state
under both transports and prints one JSON line: the relative error of
v / p / dye of the bf16 run against the f32 run at a geometric schedule
of steps, with the f32 run's RMS divergence as scale context (per-point
lines go to stderr).

    python -m fluid2d_tpu_torch.scripts.bf16_drift --res 1600 --steps 2000
    python -m fluid2d_tpu_torch.scripts.bf16_drift --res 64 --steps 200 --device cpu

``--device`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fluid2d_tpu_torch.config import SimConfig, resolve_device
from fluid2d_tpu_torch.models.simulator import make_run_fn, scene_for_dtype
from fluid2d_tpu_torch.scenes.compile import get_scene
from fluid2d_tpu_torch.state import init_state
from fluid2d_tpu_torch.utils.metrics import _diag_arrays

__all__ = ["rel_err", "marks_for", "main"]

FIELDS = ("v", "p", "dye")


def rel_err(a, b):
    """max and RMS of |a−b| over the f32 run's max|field| scale."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-6)
    d = np.abs(a - b)
    return float(d.max() / scale), float(np.sqrt((d * d).mean()) / scale)


def marks_for(steps: int, points: int) -> list[int]:
    """Geometric checkpoint schedule: 1, ~r, ~r², …, steps."""
    marks, m = [], 1
    while m < steps:
        marks.append(m)
        m = max(m + 1, int(round(m * (steps ** (1 / (points - 1))))))
    marks.append(steps)
    return marks


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--bc", type=int, default=2)
    p.add_argument("--scheme", type=str, default="cip",
                   choices=["upwind", "kk", "cip"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--points", type=int, default=6,
                   help="number of checkpoints (geometric up to --steps)")
    p.add_argument("--kernels", type=str, default="auto", choices=["auto", "cuda", "eager"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    marks = marks_for(args.steps, args.points)

    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = SimConfig.create(resolution=args.res, re=1e6, scheme=args.scheme,
                               vor_eps=5.0, enable_dye=True,
                               kernels=args.kernels, dtype=dtype)
        scene = scene_for_dtype(get_scene(args.bc, args.res, dev), cfg)
        state = init_state(scene, cfg, dev)
        run = make_run_fn(cfg)
        snaps, done = [], 0
        for m in marks:
            state = run(state, scene, m - done)
            done = m
            # Host float32 copies of the compared fields: the run goes on
            # from the device state.
            snaps.append({f: getattr(state, f).float().cpu().numpy() for f in FIELDS})
        runs[dtype] = (snaps, scene, cfg)

    rows = []
    for i, m in enumerate(marks):
        s16 = runs["bfloat16"][0][i]
        s32 = runs["float32"][0][i]
        row = {"step": m}
        for name in FIELDS:
            mx, rms = rel_err(s16[name], s32[name])
            row[f"{name}_max"] = round(mx, 5)
            row[f"{name}_rms"] = round(rms, 6)
        _, scene32, cfg32 = runs["float32"]
        div_rms, _, _, _ = _diag_arrays(torch.from_numpy(s32["v"]), torch.from_numpy(s32["p"]),
                                        scene32.fluid.cpu(), cfg32.dx)
        row["f32_div_rms"] = round(float(div_rms), 5)
        row["bf16_nan"] = bool(np.isnan(s16["v"]).any())
        rows.append(row)
        print(f"# step {m:6d}: "
              + "  ".join(f"{k}={v}" for k, v in row.items() if k != "step"),
              file=sys.stderr)

    out = {
        "res": args.res, "bc": args.bc, "scheme": args.scheme,
        "backend": dev.type, "kernels": args.kernels,
        "drift": rows,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
