"""Benchmark harness of the port: simulation steps/s on one CUDA card.

    python -m fluid2d_tpu_torch.bench [--res 1600] [--scheme cip] [--steps 200]
                                      [--all] [--config N|all] [--roofline]
                                      [--dtype float32] [--device cuda]

The headline is steps/s at res=1600 with CIP advection and SOR (dye and
vorticity confinement on, as in the reference's defaults): each timed run
of n steps follows a warm-up run of the same n steps, and ends in a
synchronize and a device→host read. Prints ONE JSON line,
``{"metric", "value", "unit", "device"}``; ``--config`` prints the presets
instead, ``--roofline`` first prints ``{"roofline": {...}}``
(``utils/profiling.py:roofline_report``) and ``--all`` a side table of
configurations on stderr.

``--device`` defaults to ``cuda`` and raises when no card is there: a
measurement never falls back to the CPU. ``--device cpu`` runs the plain
PyTorch versions (a check of the harness, not a measurement of the card).
``--dtype bfloat16`` stores the state in bf16 (arithmetic stays float32);
its metrics carry the suffix ``_bfloat16``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from fluid2d_tpu_torch.config import SimConfig, resolve_device
from fluid2d_tpu_torch.models.simulator import make_run_fn, scene_for_dtype
from fluid2d_tpu_torch.scenes.compile import get_scene
from fluid2d_tpu_torch.state import SimState, init_state
from fluid2d_tpu_torch.utils.profiling import device_name, roofline_report, time_steps

__all__ = ["bench_config", "run_preset", "main"]


def bench_config(res: int, scheme: str, steps: int, *, enable_dye=True, vor_eps=5.0, bc=2,
                 re=1_000_000.0, dt=None, dtype="float32",
                 device="cuda") -> tuple[float, SimState]:
    """Steps/s of `steps` timed steps after a warm-up of `steps` steps, from
    the zero state of scene `bc` at `res`; returns it with the state after
    all 2·steps steps."""
    dev = resolve_device(device)
    cfg = SimConfig.create(resolution=res, re=re, dt=dt, scheme=scheme, vor_eps=vor_eps,
                           enable_dye=enable_dye, dtype=dtype)
    scene = scene_for_dtype(get_scene(bc, res, dev), cfg)
    sec_per_step, state = time_steps(make_run_fn(cfg), init_state(scene, cfg, dev), scene,
                                     steps)
    return 1.0 / sec_per_step, state


# The JAX package's presets (bench.py at the repository root), step counts
# included; copied, not imported, so that the port imports no JAX.
_PRESETS = {
    1: {"desc": "bc=1 channel flow, res=400, upwind, Re=1000, dt=5e-4",
        "kw": {"res": 400, "scheme": "upwind", "bc": 1, "re": 1000.0,
               "dt": 5e-4, "vor_eps": None, "enable_dye": False},
        "steps": 2000},
    2: {"desc": "bc=2 obstacle flow, res=800, Kawamura-Kuwahara, Re=1000",
        "kw": {"res": 800, "scheme": "kk", "bc": 2, "re": 1000.0},
        "steps": 1000},
    3: {"desc": "bc=3 Re=1e8, res=800, CIP + vorticity confinement vc=10",
        "kw": {"res": 800, "scheme": "cip", "bc": 3, "re": 1e8, "vor_eps": 10.0},
        "steps": 600},
    4: {"desc": "bc=5 multi-obstacle mask, res=1600, CIP + dye/vorticity",
        "kw": {"res": 1600, "scheme": "cip", "bc": 5},
        "steps": 300},
    5: {"desc": "bc=6 dragon mask, res=1600, CIP + dye/vorticity",
        "kw": {"res": 1600, "scheme": "cip", "bc": 6},
        "steps": 300},
    6: {"desc": "res=4096 obstacle sweep (bc=3), CIP — single chip "
               "(the v5p-8 sharded leg needs real multi-chip hardware)",
        "kw": {"res": 4096, "scheme": "cip", "bc": 3},
        "steps": 80},
}


def run_preset(n: int, dtype: str = "float32", device="cuda") -> dict:
    """Preset `n` at its own step count; stable means every velocity value
    is finite."""
    p = _PRESETS[n]
    rate, state = bench_config(steps=p["steps"], dtype=dtype, device=device, **p["kw"])
    finite = bool(torch.isfinite(state.v).all())
    metric = f"baseline_config_{n}"
    if dtype != "float32":
        metric += f"_{dtype}"
    return {
        "metric": metric,
        "desc": p["desc"],
        "value": rate if finite else 0.0,
        "unit": "steps/s",
        "stable": finite,
        "device": device_name(state.v.device),
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--res", type=int, default=1600)
    parser.add_argument("--scheme", type=str, default="cip", choices=["upwind", "kk", "cip"])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                        help="Transport (storage) dtype of the state; arithmetic is float32")
    parser.add_argument("--all", action="store_true", help="Print a side table of configs")
    parser.add_argument("--config", type=str, default=None, help="Preset number 1..6, or 'all'")
    parser.add_argument("--roofline", action="store_true",
                        help="Print the measured roofline report first")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    if args.config:
        nums = sorted(_PRESETS) if args.config == "all" else [int(args.config)]
        rows = [run_preset(n, args.dtype, dev) for n in nums]
        for r, n in zip(rows, nums):
            print(f"# config {n}: {r['value']:9.1f} steps/s "
                  f"stable={r['stable']}  ({r['desc']})", file=sys.stderr)
        print(json.dumps(rows if len(rows) > 1 else rows[0]))
        return

    if args.roofline:
        rep = roofline_report(args.res, args.scheme, args.steps, dtype=args.dtype, device=dev)
        print(json.dumps({"roofline": rep}))
        for k, v in rep.items():
            out = f"{v:.2f}" if isinstance(v, (int, float)) else v
            print(f"# {k}: {out}", file=sys.stderr)

    if args.all:
        for res, steps in ((400, 2000), (800, 1000), (1600, 400), (4096, 80)):
            for scheme in ("upwind", "kk", "cip"):
                rate, _ = bench_config(res, scheme, steps, dtype=args.dtype, device=dev)
                print(f"# res={res:5d} scheme={scheme:6s}: {rate:9.1f} steps/s", file=sys.stderr)

    rate, state = bench_config(args.res, args.scheme, args.steps, dtype=args.dtype, device=dev)
    metric = f"steps_per_sec_res{args.res}_{args.scheme}"
    if args.dtype != "float32":
        metric += f"_{args.dtype}"
    finite = bool(torch.isfinite(state.v).all())  # a benchmark of NaNs is not a benchmark
    print(json.dumps({"metric": metric, "value": rate if finite else 0.0, "unit": "steps/s",
                      "device": device_name(dev)}))


if __name__ == "__main__":
    main()
