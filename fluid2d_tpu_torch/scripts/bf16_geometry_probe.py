"""Does halving the bytes per element halve a kernel's operand-mix floor?
(probe C5c)

The port of ``scripts/bf16_geometry_probe.py``: the no-op twin of a
kernel's operands (``ops/cuda_probes.py:mix_twin_cuda``, the probe C3) with
its transport planes in float32, then in bf16 (``mix_twin_bf16_cuda``, its
own kernel), then in float32 again as the health gate, at the res=1600 grid (3200×1600), for ``cip_dye_phase`` and
``cip_velocity_phase``. A byte-bound twin runs the bf16 arm in about half
the float32 time. Prints one JSON line per arm with the script's keys
(``kernel``, ``dtype``, ``t``, ``ms_per_call``, ``GBps_of_mix_bytes``,
``time_vs_f32``, ``gate_drift_pct``). ``t`` is null: the script's tile and
its "bf16 at 2× tile" arm have no counterpart, because the port's kernels
have no tile (one thread per cell; the halo comes from the caches).

    python -m fluid2d_tpu_torch.scripts.bf16_geometry_probe [--res 1600]
"""

from __future__ import annotations

import argparse
import json

from fluid2d_tpu_torch.config import resolve_device
from fluid2d_tpu_torch.utils.profiling import measure_mix_ceiling

__all__ = ["CASES", "geometry_rows", "main"]

CASES = ("cip_dye_phase", "cip_velocity_phase")


def geometry_rows(name: str, res: int = 1600, device="cuda", iters: int | None = None) -> list:
    """The f32, bf16 and f32-again arms of kernel `name`'s twin at `res`."""
    dev = resolve_device(device)
    x_rows, y_cols = 2 * res, res
    arms = []
    for dtype in ("float32", "bfloat16", "float32"):
        bps, nbytes = measure_mix_ceiling(name, x_rows, y_cols, iters, dev, dtype)
        arms.append((dtype, nbytes / bps, nbytes))
    sec32 = arms[0][1]
    drift = 100.0 * abs(arms[2][1] - sec32) / sec32
    return [{"kernel": name, "dtype": "f32/regate" if k == 2 else dtype, "t": None,
             "ms_per_call": sec * 1e3, "GBps_of_mix_bytes": nbytes / sec / 1e9,
             "time_vs_f32": sec / sec32, "gate_drift_pct": drift}
            for k, (dtype, sec, nbytes) in enumerate(arms)]


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--res", type=int, default=1600)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    for name in CASES:
        for row in geometry_rows(name, args.res, args.device):
            print(json.dumps(row))


if __name__ == "__main__":
    main()
