"""Do 16-byte asynchronous copies move bf16 row windows at 8-row offsets
intact? (probe C5b)

The port of ``scripts/bf16_dma_probe.py``, whose three cases asked whether
the TPU's DMA engine could move bf16 row slices at offsets that are
multiples of 8 but not of bf16's 16-row tile. On this card the same three
window moves go through shared memory with ``cp.async`` 16-byte copies
(``ops/cuda_dtype_probes.py:row_copy_cuda``), for float32 and bf16 on a
(256, 256) plane with t = 16:

  1. tail     rows [8, 8+t) → shared memory → out;
  2. head     rows [0, t+16) → shared; rows [8, 24) → rows [0, 16); out;
  3. realign  rows [0, t+16) → shared; win[8:] = win[:t+8]; out.

Each case must be bit-equal to its plain slice. Prints one line per case
and dtype, "ok" or "FAIL", as the script does, then one JSON line
``{"<dtype> <case>": true|false, ...}``; exits 1 if a case failed.

    python -m fluid2d_tpu_torch.scripts.bf16_dma_probe
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from fluid2d_tpu_torch.config import resolve_device
from fluid2d_tpu_torch.ops.cuda_dtype_probes import COPY_MODES, row_copy_cuda, row_copy_plain
from fluid2d_tpu_torch.utils.profiling import device_name

__all__ = ["probe", "main"]

_LABEL = {"tail": "tail (global row slice @8)", "head": "head (shared→shared @8)",
          "realign": "realign (win[8:]=win[:-8])"}


def probe(dtype: torch.dtype, device, rows: int = 256, cols: int = 256, t: int = 16) -> dict:
    """Each copy of a (rows, cols) plane of `dtype` against its plain
    slice; prints one line per case and returns ``{case: bit-equal}``."""
    x = (torch.arange(rows * cols, dtype=torch.float32).reshape(rows, cols) * 1e-4).to(dtype)
    x = x.to(device)
    name = str(dtype).removeprefix("torch.")
    res = {}
    for mode in COPY_MODES:
        got = row_copy_cuda(x, mode, t)
        ok = bool(torch.equal(got.cpu(), row_copy_plain(x.cpu(), mode, t)))
        print(f"{name} {_LABEL[mode]}: {'ok (bit-equal)' if ok else 'FAIL (differs)'}",
              flush=True)
        res[f"{name} {mode}"] = ok
    return res


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        print(f"--- {str(dt).removeprefix('torch.')} ---")
        results |= probe(dt, dev)
    print(json.dumps(results))
    if not all(results.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
