"""Can a full row window at lane width 1600 be copied asynchronously?
(probe C5g)

The port of ``scripts/dma_rowwin_1600_check.py``, whose TPU kernel copied a
(t + 2h, Y) row window of a (3200, Y) float32 array into VMEM with one
asynchronous DMA per tile, realigned the edge tiles in place and wrote
``2 · window[h : h + t]``. Here the window goes into a block's shared memory
by Hopper bulk copies, one ``cp.async.bulk`` a row completing on an mbarrier
(``ops/cuda_probes.py:row_window_cuda``, ``csrc/probes.cu``), with the same
clamp of the window's first row and the same realignment of the edge tiles.

A block has at most 232,448 bytes of shared memory, so the TPU's t = 32
(48 rows × 1600 floats, 307,200 bytes) does not fit: t is the largest multiple
of 8 dividing 3200 whose window fits beside its barrier (t = 16 at Y = 1600,
204,800 bytes). At a Y where no t fits (Y = 4096: one row is 16 KB) it prints
"does not fit" before any launch. Otherwise it prints t, the window's bytes,
``OK`` or ``WRONG`` (the output against ``2 · a``, bit for bit) and the time
of a call beside ``torch.mul(a, 2.0, out=o)``; it exits 1 on ``WRONG``.

    python -m fluid2d_tpu_torch.scripts.dma_rowwin_1600_check [Y]
"""

from __future__ import annotations

import argparse
import sys

import torch

from fluid2d_tpu_torch.bench import resolve_device
from fluid2d_tpu_torch.ops.cuda_probes import ROW_WINDOW_SMEM, row_window_cuda, row_window_tile
from fluid2d_tpu_torch.utils.profiling import device_name, seconds_per_call

__all__ = ["X_ROWS", "HALO", "check", "main"]

X_ROWS, HALO = 3200, 8


def check(y: int = 1600, iters: int = 200, device="cuda") -> dict:
    """The copy at lane width `y`: t, the window's bytes, whether it fits,
    whether it is bit-equal to ``2 · a``, and the ms of a call and of
    ``torch.mul(a, 2.0, out=o)``. Prints one line."""
    dev = resolve_device(device)
    t = row_window_tile(X_ROWS, y, HALO)
    if t is None:
        print(f"lane width {y}: no t (a multiple of 8 dividing {X_ROWS}) gives a window of "
              f"t + {2 * HALO} rows of {y * 4} bytes within {ROW_WINDOW_SMEM} bytes of shared "
              f"memory: does not fit", flush=True)
        return {"y": y, "t": None, "fits": False}
    window = (t + 2 * HALO) * y * 4
    a = torch.arange(X_ROWS * y, dtype=torch.float32).reshape(X_ROWS, y).to(dev)
    ok = bool(torch.equal(row_window_cuda(a, t, HALO), 2.0 * a))
    ms = seconds_per_call(lambda: row_window_cuda(a, t, HALO), iters, dev) * 1e3
    o = torch.empty_like(a)
    mul_ms = seconds_per_call(lambda: torch.mul(a, 2.0, out=o), iters, dev) * 1e3
    print(f"lane width {y}: t={t}, window {t + 2 * HALO}×{y} floats = {window} bytes: copy ran, "
          f"values {'OK' if ok else 'WRONG'}; {ms:.4f} ms a call, torch.mul(a, 2.0, out=o) "
          f"{mul_ms:.4f} ms", flush=True)
    return {"y": y, "t": t, "fits": True, "window_bytes": window, "ok": ok, "ms": ms,
            "mul_ms": mul_ms}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("y", type=int, nargs="?", default=1600, help="lane width Y")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")
    res = check(args.y, args.iters, dev)
    if res["fits"] and not res["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
