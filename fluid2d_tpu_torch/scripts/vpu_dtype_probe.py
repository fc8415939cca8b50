"""Does the card run bf16 arithmetic faster than float32? (probe C5a)

The port of ``scripts/vpu_dtype_probe.py``: one kernel per dtype runs a
long chain of the chosen op mix on every element of a (rows, cols) array
(``ops/cuda_dtype_probes.py:dtype_rate_cuda``; bf16 two lanes per
instruction), timed with CUDA events over `iters` launches. Before timing,
each dtype is held to its plain version on the timed inputs, at
``RATE_CHECK_PASSES`` passes and at the timed depth, within
``RATE_TOL_ULPS`` per element; at the check depth the plain version a step
short or long must fail that check at every element. Prints one JSON line
with the script's keys: ``{"mode", "passes", "float32", "bfloat16", "bf16_over_f32"}``
(G element-ops/s, one element-op per pass per element). The script's
``--tile`` has no counterpart: the kernel has no tile. The default depth is
deeper than the script's 256 passes, so that the arithmetic, not the 16 MB
of loads and stores, dominates a launch on this card.

    python -m fluid2d_tpu_torch.scripts.vpu_dtype_probe [--mode fma] [--passes 3072]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from fluid2d_tpu_torch.bench import resolve_device
from fluid2d_tpu_torch.ops.cuda_dtype_probes import (
    PASSES_PER_STEP,
    RATE_CHECK_PASSES,
    RATE_MODES,
    RATE_TOL_ULPS,
    dtype_rate_cuda,
    dtype_rate_plain,
    ulps_apart,
)
from fluid2d_tpu_torch.utils.profiling import seconds_per_call

__all__ = ["check_dtype_rate", "measure_dtype_rate", "main"]

DTYPES = (torch.float32, torch.bfloat16)


def _inputs(rows: int, cols: int, dtype: torch.dtype, device, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return (2.0 + torch.rand((rows, cols), generator=gen)).to(dtype).to(device)


def check_dtype_rate(mode: str, dtype: torch.dtype, device, rows: int = 2048,
                     cols: int = 1024, passes: int | None = None,
                     x: torch.Tensor | None = None) -> dict:
    """The kernel on `x` (by default the probe's seeded (rows, cols) inputs
    in `dtype`) against its plain version at RATE_CHECK_PASSES, per element
    within RATE_TOL_ULPS; the plain version a step short and a step long
    must miss it by more at every element. With `passes`, also at that depth
    within RATE_TOL_ULPS: the chains sit at their fixed point there, so a
    step more or fewer is no control, but wrong arithmetic shows. Raises on
    a failure; returns the errors in units in the last place."""
    if x is None:
        x = _inputs(rows, cols, dtype, device, seed=1)
    if x.dtype != dtype:
        msg = f"dtype_rate check at {dtype} given {x.dtype} inputs"
        raise TypeError(msg)
    step = PASSES_PER_STEP[mode]
    tol = RATE_TOL_ULPS[dtype]
    got = dtype_rate_cuda(x, RATE_CHECK_PASSES, mode)
    err = _held(got, dtype_rate_plain(x, RATE_CHECK_PASSES, mode), tol,
                f"dtype_rate[{mode}, {dtype}] at {RATE_CHECK_PASSES} passes")
    miss = min(float(ulps_apart(got, dtype_rate_plain(x, RATE_CHECK_PASSES + d, mode)).min())
               for d in (-step, step))
    if miss <= tol:
        msg = f"dtype_rate[{mode}, {dtype}]: a step more or fewer is within {tol} ulps ({miss})"
        raise AssertionError(msg)
    out = {"max_err_ulps": err, "tol_ulps": tol, "one_step_off_min_ulps": miss}
    if passes is not None:
        out["max_err_ulps_deep"] = _held(dtype_rate_cuda(x, passes, mode),
                                         dtype_rate_plain(x, passes, mode), tol,
                                         f"dtype_rate[{mode}, {dtype}] at {passes} passes")
    return out


def _held(got: torch.Tensor, ref: torch.Tensor, tol: float, what: str) -> float:
    """The largest distance of got from ref in ulps; raises past tol or on
    a non-finite value."""
    err = float(ulps_apart(got, ref).max())
    if not (err <= tol and bool(torch.isfinite(got.float()).all())):
        msg = f"{what}: {err} ulps from the plain version (tolerance {tol})"
        raise AssertionError(msg)
    return err


def measure_dtype_rate(mode: str = "fma", passes: int = 3072, rows: int = 2048,
                       cols: int = 1024, iters: int = 20, device="cuda") -> dict:
    """G element-ops/s of each dtype (``passes`` per element per launch)
    and their ratio, after the checks of :func:`check_dtype_rate` on the
    timed inputs at the check depth and at ``passes``; also the ms per
    launch and the checks' errors of each dtype."""
    dev = resolve_device(device)
    out: dict = {"mode": mode, "passes": passes}
    ms, checks = {}, {}
    for dt in DTYPES:
        name = str(dt).removeprefix("torch.")
        x = _inputs(rows, cols, dt, dev)
        checks[name] = check_dtype_rate(mode, dt, dev, passes=passes, x=x)
        sec = seconds_per_call(lambda x=x: dtype_rate_cuda(x, passes, mode), iters, dev)
        out[name] = rows * cols * passes / sec / 1e9
        ms[name] = sec * 1e3
    out["bf16_over_f32"] = out["bfloat16"] / out["float32"]
    out["ms"] = ms
    out["checks"] = checks
    return out


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=2048)
    p.add_argument("--cols", type=int, default=1024)
    p.add_argument("--passes", type=int, default=3072,
                   help="chained element-ops per element per launch (a multiple of 12 "
                        "suits every mode)")
    p.add_argument("--iters", type=int, default=20, help="timed launches per dtype")
    p.add_argument("--mode", type=str, default="fma", choices=list(RATE_MODES))
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    res = measure_dtype_rate(args.mode, args.passes, args.rows, args.cols, args.iters,
                             args.device)
    for name in ("float32", "bfloat16"):
        print(f"# {name:9s} {args.mode:7s} passes={args.passes} {res['ms'][name]:8.4f} ms  "
              f"{res[name]:10.1f} Gel/s", file=sys.stderr)
    print(json.dumps({k: res[k] for k in ("mode", "passes", "float32", "bfloat16",
                                          "bf16_over_f32")}))


if __name__ == "__main__":
    main()
