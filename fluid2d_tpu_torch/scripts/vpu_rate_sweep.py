"""Find the card's best FP32 FMA rate: a sweep over block size, chain count
and depth (probe C5d).

The port of ``scripts/vpu_rate_sweep.py``. One launch runs `nchain`
independent chains of ``a = fma(a, c1, c2)`` on every element of a (2048,
1024) float32 array, `depth` FMAs an element in all, then sums the chains
(``ops/cuda_probes.py:fma_sweep_cuda``, ``csrc/probes.cu:fma_rate_kernel``,
the C4 kernel with its chain count a template parameter). The sweep covers
the script's grid: chains {1, 4, 8} × depth {64, 256, 1024} × three block
sizes. The script's block rows t ∈ {8, 32, 256} (VMEM blocks of t rows)
become 64, 256 and 1024 threads a block: the card has no VMEM block, and the
thread block is what a launch sizes. Each case is timed with CUDA events over
`iters` launches.

El-op accounting is the script's: one FMA counts 2 weighted element-ops, so a
launch does ``rows·cols·(2·(depth//nchain)·nchain + 2·nchain − 1)`` (the FMAs,
the nchain start multiplies and the nchain − 1 merge adds). The inputs are
seeded in [0, 1) where the script used 0.5, and C4's constants (c1 =
1.000001, c2 = 1e-3) replace the script's c2 = 1e-6, so that before timing
each (chains, depth) is held to the float64 plain version within
``fma_rate_error_bound`` and the plain version one round short must miss it at
every element, as C4 is checked. The script's ``--dtype`` has no counterpart:
the bf16 rate is probe C5a's.

Prints one line per case and ``BEST``, as the script does.

    python -m fluid2d_tpu_torch.scripts.vpu_rate_sweep [--iters 50]
"""

from __future__ import annotations

import argparse

import torch

from fluid2d_tpu_torch.config import resolve_device
from fluid2d_tpu_torch.ops.cuda_probes import (
    FMA_SWEEP_CHAINS,
    fma_rate_error_bound,
    fma_rate_plain,
    fma_sweep_cuda,
)
from fluid2d_tpu_torch.utils.profiling import device_name, seconds_per_call

__all__ = ["BLOCK_THREADS", "DEPTHS", "elops_per_launch", "sweep_inputs", "check_chains", "sweep",
           "main"]

BLOCK_THREADS = {8: 64, 32: 256, 256: 1024}  # the script's block rows t → threads a block
DEPTHS = (64, 256, 1024)


def elops_per_launch(rows: int, cols: int, nchain: int, depth: int) -> int:
    """Weighted element-ops of one launch, the script's accounting."""
    return rows * cols * (2 * (depth // nchain) * nchain + 2 * nchain - 1)


def sweep_inputs(rows: int, cols: int, device, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.rand((rows, cols), generator=gen).to(device)


def check_chains(x: torch.Tensor, nchain: int, depth: int, threads: int = 256) -> dict:
    """The kernel on `x` against the float64 plain version: within
    fma_rate_error_bound at every element, and the plain version one round
    short beyond it at every element. Raises on a failure; returns the
    error, the bound and the control's least distance."""
    got = fma_sweep_cuda(x, depth, nchain, threads).double()
    bound = fma_rate_error_bound(x, depth, nchain)
    err = float((got - fma_rate_plain(x.double(), depth, nchain)).abs().max())
    if not err <= bound:
        msg = f"fma_sweep[chains={nchain}, depth={depth}]: error {err} > bound {bound}"
        raise AssertionError(msg)
    miss = float((got - fma_rate_plain(x.double(), depth - nchain, nchain)).abs().min())
    if not miss > bound:
        msg = (f"fma_sweep[chains={nchain}, depth={depth}]: one round short is within the "
               f"bound {bound} ({miss}) at some element")
        raise AssertionError(msg)
    return {"max_abs_err": err, "bound": bound, "one_round_short_min_err": miss}


def sweep(rows: int = 2048, cols: int = 1024, iters: int = 50, device="cuda") -> dict:
    """Every (block, chains, depth) case after the checks of
    :func:`check_chains` on the timed inputs; returns ``{"cases": [...],
    "best": ..., "checks": ...}`` with G weighted el-ops/s and ms a launch."""
    dev = resolve_device(device)
    x = sweep_inputs(rows, cols, dev)
    checks = {f"chains={n} depth={d}": check_chains(x, n, d)
              for n in FMA_SWEEP_CHAINS for d in DEPTHS}
    cases, best = [], None
    for t, threads in BLOCK_THREADS.items():
        for nchain in FMA_SWEEP_CHAINS:
            for depth in DEPTHS:
                sec = seconds_per_call(lambda: fma_sweep_cuda(x, depth, nchain, threads), iters,
                                       dev)
                rate = elops_per_launch(rows, cols, nchain, depth) / sec
                tag = f"t={t:4d} threads={threads:4d} chains={nchain} depth={depth:5d}"
                print(f"{tag}: {rate / 1e9:8.1f} G weighted-elops/s", flush=True)
                case = {"t": t, "threads": threads, "chains": nchain, "depth": depth,
                        "ms": sec * 1e3, "Gelops": rate / 1e9, "tag": tag}
                cases.append(case)
                if best is None or rate > best["Gelops"] * 1e9:
                    best = case
    print(f"BEST: {best['tag']} → {best['Gelops']:.1f} G/s", flush=True)
    return {"cases": cases, "best": best, "checks": checks}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--rows", type=int, default=2048)
    p.add_argument("--cols", type=int, default=1024)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")
    sweep(args.rows, args.cols, args.iters, dev)


if __name__ == "__main__":
    main()
