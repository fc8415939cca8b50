"""What does an operand geometry cost on the card? A one-axis-at-a-time
sweep of the geometry twin (probe C5e).

The port of ``scripts/dma_geometry_sweep.py``, which asked what controls the
TPU's DMA throughput. Every case here is the geometry twin
(``ops/cuda_probes.py:geometry_twin_cuda``, ``csrc/probes.cu``): `n_in`
distinct float32 inputs, each read in full (with a halo reach h also at rows
i ± h, clamped), summed in float32, the sum written to `n_out` outputs, at the
res grid (3200×1600 by default) unless the section says otherwise. Each case
is held to its plain version within 1e-5·max(1, |ref|max), then timed with
CUDA events over enough launches that about 0.3 TB moves (at most 20000, at
least ``--iters``; on the CPU, which times the plain version, ``--iters``).
GB/s is the compulsory bytes (each operand once, the byte ledger's
convention; the TPU script counted its re-fetched halo rows) over the time,
so a halo read that costs time shows as a lower rate.

Sections (the script's names and cases; what each means on this card):

  incount   n_in ∈ {1, 2, 4, 8, 13, 23} planes, 1 output
  rows      the thread block's rows ∈ {1, 2, 4, 8, 16, 32} (32 threads along Y
            each), 1 in / 1 out: the block is what a launch sizes here, where
            the script swept its VMEM block rows t ∈ {8 … 256}
  lanes     Y ∈ {1600, 2048, 4096}, the same total bytes
  triples   n_in ∈ {1, 4, 9} read as halo triples: reach h = 8, the TPU
            triple's 8-row side blocks
  outs      1 input, n_out ∈ {1, 2, 6}
  cgrid     n_in ∈ {1, 7} (3, X, Y) inputs with the channel on the kernel's z
            axis
  packed    one (P, X, Y) tensor read through P offsets, one (P, X, Y) output
  windows   = triples (h = 8) with the script's counts: a TPU element window
            of t + 2h rows fetches the rows a halo triple fetches, and here
            both are the same reads
  mixes     phase-like counts: 23 in / 6 out, 9 halo triples / 6 out
  cgrid2d   = cgrid with the script's counts: its (t, Y) blocks on (3X, Y)
            arrays were a TPU block shape; here a channel is a z index either way
  bigcopy   1 in / 1 out working sets of 41 to 655 MB, and 4 in / 1 out of
            102 to 819 MB: on both sides of the card's 50 MB L2
  folded    separate planes with many outputs (h = 8), and packed P ∈ {3, 2}
  merged    = packed inputs (one allocation read through P offsets) with
            plain (X, Y) outputs, beside distinct-plane twins

Cases that differed only by the TPU block rows t appear once. Prints the copy
reference (probe C2) and one line per case; ``--json`` writes every case.

    python -m fluid2d_tpu_torch.scripts.dma_geometry_sweep [--res 1600] [--only incount,bigcopy]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from fluid2d_tpu_torch.config import resolve_device
from fluid2d_tpu_torch.ops.cuda_probes import (
    GeometryOperands,
    geometry_twin_cuda,
    geometry_twin_plain,
)
from fluid2d_tpu_torch.utils.profiling import device_name, measure_hbm_bandwidth, seconds_per_call

__all__ = ["SECTIONS", "HALO", "sections", "case_bytes", "make_case", "run_case", "main"]

HALO = 8  # the TPU halo triple's side blocks: 8 rows on each side
TOL = 1e-5
MOVE_BYTES = 3e11  # bytes a timed case moves, about
SECTIONS = ("incount", "rows", "lanes", "triples", "outs", "cgrid", "packed", "windows", "mixes",
            "cgrid2d", "bigcopy", "folded", "merged")


def sections(x: int, y: int) -> dict[str, list[tuple[str, dict]]]:
    """Every section's cases, (label, make_case keywords), at the (x, y) grid."""

    def case(**kw):
        return {"x": x, "y": y, **kw}

    def mb(n_planes: int, rows: int) -> str:
        return f"{n_planes * rows * y * 4 / 1e6:.0f} MB total"

    h = HALO
    return {
        "incount": [(f"n_in={n}", case(n_in=n)) for n in (1, 2, 4, 8, 13, 23)],
        "rows": [(f"block_rows={r}", case(block_rows=r)) for r in (1, 2, 4, 8, 16, 32)],
        "lanes": [(f"Y={yy}", {"x": max(64, x * y // yy // 64 * 64), "y": yy})
                  for yy in (1600, 2048, 4096)],
        "triples": [(f"triples n_in={n}", case(n_in=n, h=h)) for n in (1, 4, 9)],
        "outs": [(f"n_out={n}", case(n_out=n)) for n in (1, 2, 6)],
        "cgrid": [(f"cgrid n_in={n}", case(n_in=n, channels=3)) for n in (1, 7)],
        "packed": [(f"packed P={n}", case(n_in=n, packed=True, packed_out=True))
                   for n in (6, 13, 23)]
        + [("packed P=23 triples", case(n_in=23, packed=True, packed_out=True, h=h))],
        "windows": [(f"windows n_in={n}", case(n_in=n, h=h)) for n in (1, 4, 9)]
        + [(f"windows n_in={n} n_out=6", case(n_in=n, n_out=6, h=h)) for n in (9, 16)],
        "mixes": [("n_in=23 n_out=6", case(n_in=23, n_out=6)),
                  ("n_in=9 triples n_out=6", case(n_in=9, n_out=6, h=h))],
        "cgrid2d": [(f"cgrid n_in={n}", case(n_in=n, channels=3)) for n in (7, 8)]
        + [("cgrid n_in=8 n_out=6", case(n_in=8, n_out=6, channels=3)),
           ("cgrid windows n_in=8 n_out=6", case(n_in=8, n_out=6, channels=3, h=h))],
        "bigcopy": [(f"copy {mb(2, k * x)}", {"x": k * x, "y": y}) for k in (1, 2, 4, 8, 16)]
        + [(f"4-in {mb(5, k * x)}", {"x": k * x, "y": y, "n_in": 4}) for k in (1, 4, 8)],
        "folded": [(f"windows n_in={n} n_out={o}", case(n_in=n, n_out=o, h=h))
                   for n, o in ((23, 18), (15, 12), (12, 9))]
        + [(f"packed P={n}", case(n_in=n, packed=True, packed_out=True)) for n in (3, 2)],
        "merged": [(f"merged n_in={n}", case(n_in=n, packed=True)) for n in (4, 8, 13, 23)]
        + [("merged n_in=8 triples", case(n_in=8, packed=True, h=h)),
           ("triples n_in=8", case(n_in=8, h=h)),
           ("windows n_in=8 n_out=6", case(n_in=8, n_out=6, h=h)),
           ("windows n_in=4 n_out=3", case(n_in=4, n_out=3, h=h)),
           ("windows n_in=8 n_out=3", case(n_in=8, n_out=3, h=h))],
    }


def case_bytes(x: int, y: int, n_in: int = 1, n_out: int = 1, h: int = 0, channels: int = 1,
               packed: bool = False, packed_out: bool = False, block_rows: int = 8) -> int:
    """The compulsory bytes of one launch: each input plane read once, each
    output plane written once (a packed output is n_in planes)."""
    out_planes = n_out * (n_in if packed_out else 1)
    return 4 * x * y * channels * (n_in + out_planes)


def make_case(x: int, y: int, n_in: int = 1, n_out: int = 1, h: int = 0, channels: int = 1,
              packed: bool = False, packed_out: bool = False, block_rows: int = 8,
              device="cuda", seed: int = 0) -> GeometryOperands:
    """The twin's operands: `n_in` distinct seeded normal inputs ((x, y), or
    (channels, x, y)), or with `packed` the n_in planes of one (n_in, x, y)
    tensor; `n_out` fresh outputs, each with `packed_out` one (n_in, x, y)
    tensor's planes."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (channels, x, y) if channels > 1 else (x, y)
    if packed:
        ins = list(torch.randn((n_in, *shape), generator=gen, device=dev).unbind(0))
    else:
        ins = [torch.randn(shape, generator=gen, device=dev) for _ in range(n_in)]
    outs = None
    if packed_out:
        outs = [o for _ in range(n_out)
                for o in torch.empty((n_in, *shape), device=dev).unbind(0)]
    return GeometryOperands(ins, n_out=n_out, h=h, block_rows=block_rows, outs=outs)


def run_case(label: str, kw: dict, iters: int, device) -> dict:
    """One case: built, held to its plain version within TOL, timed. Returns
    its row (label, the keywords, MB, ms, GB/s, the error)."""
    ops = make_case(**kw, device=device)
    nbytes = ops.nbytes
    got = geometry_twin_cuda(ops)
    ref = geometry_twin_plain(ops)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(1.0, max(float(r.abs().max()) for r in ref))
    if not err <= TOL * scale:
        msg = f"geometry twin [{label}]: max error {err} > {TOL} * {scale}"
        raise AssertionError(msg)
    n = min(20000, max(iters, int(MOVE_BYTES / nbytes))) if ops.device.type == "cuda" else iters
    sec = seconds_per_call(lambda: geometry_twin_cuda(ops), n, ops.device)
    row = {"case": label, **kw, "MB": nbytes / 1e6, "ms": sec * 1e3,
           "GBps": nbytes / sec / 1e9, "max_abs_err": err, "launches": n}
    print(f"  {label:40s}: {nbytes / 1e6:7.1f} MB in {sec * 1e3:8.4f} ms = "
          f"{row['GBps']:7.1f} GB/s", flush=True)
    return row


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--res", type=int, default=1600)
    p.add_argument("--iters", type=int, default=300, help="least timed launches a case")
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--only", type=str, default=None,
                   help=f"comma-separated section names ({','.join(SECTIONS)})")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    want = SECTIONS if args.only is None else tuple(args.only.split(","))
    unknown = sorted(set(want) - set(SECTIONS))
    if unknown:
        p.error(f"unknown sections {unknown}; choose from {','.join(SECTIONS)}")
    x, y = 2 * args.res, args.res
    print(f"device: {device_name(dev)}")
    if dev.type == "cuda":
        bw = measure_hbm_bandwidth(device=dev) / 1e9
    else:
        bw = measure_hbm_bandwidth(mbytes=2, iters=2, device=dev) / 1e9
    print(f"streaming copy reference (C2, 320 MB in+out): {bw:7.1f} GB/s", flush=True)
    results = []
    for name, cases in sections(x, y).items():
        if name not in want:
            continue
        print(f"\n{name}:", flush=True)
        for label, kw in cases:
            results.append({"section": name, **run_case(label, kw, args.iters, dev)})
    out = {"copy_GBps": bw, "res": args.res, "device": device_name(dev), "cases": results}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
        print(f"\nwrote {args.json}")
    return out


if __name__ == "__main__":
    main()
