"""Readings of the check's numbers over many seeds in one process, for
setting each limit: the program as the configuration states it, and the
control, the program with its bf16 transport path switched on (the state
stored in bfloat16, the precision next below the configuration's float32).

    python3 -m bench_port.control --workload <cell> --dtype float32 --seconds 2 --seeds 1 2 3 ...
    python3 -m bench_port.control --workload <cell> --dtype bfloat16 --seconds 2 --seeds 4 5 6

Each seed is a run as the benchmark makes it (:func:`bench_port.run.drive`:
the checked first call, the warm-up, a window of `--seconds` at the cell's
own load, the checked last call, the plain reference), with the state
stored in `--dtype`; it prints the run's numbers, one JSON line a seed on
standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from bench_port import registry
from bench_port.run import drive

__all__ = ["readings", "main"]


def readings(cell_name: str, dtype: str, seeds, device, seconds: float = 2.0,
             root=registry.ROOT, bench=None):
    """Yield ``{"cell", "seed", "dtype", <numbers>, "seconds"}`` for each seed."""
    bench = registry.load_benchmark() if bench is None else bench
    cell = registry.cell(bench, cell_name)
    cfg = {**registry.config(cell["config"], root), "dtype": dtype}
    traffic = registry.traffic(cell["traffic"], root)
    for seed in seeds:
        t0 = time.perf_counter()
        _, numbers, _ = drive(cfg, traffic, seed, seconds, False, device, root)
        yield {"cell": cell_name, "seed": seed, "dtype": dtype, **numbers,
               "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    for r in readings(args.workload, args.dtype, args.seeds, "cuda", args.seconds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
