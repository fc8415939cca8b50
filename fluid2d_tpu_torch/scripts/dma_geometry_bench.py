"""Is the CIP dye phase held by its operand geometry, or by its work?
(probe C5f)

The port of ``scripts/dma_geometry_bench.py``, which built a no-op kernel
with the TPU dye kernel's exact operand geometry and a near-empty body. Here
the twin is the geometry twin (``ops/cuda_probes.py:geometry_twin_cuda``),
which reads every element of every input (the TPU body read one scalar a
block, because a BlockSpec moved the whole block anyway; on this card only the
bytes read move, so the twin must read them all, as the sweep's twin does):

  1. the CIP dye phase's operand mix (``utils/profiling.py`` registry,
     ``cip_dye_phase``: 7 (3, X, Y) fields, the (2, X, Y) velocity and 3 int8
     masks in, 6 (3, X, Y) fields out; channels on the kernel's z axis, the
     velocity and masks shared) read with the A4 stencil's reach, h = 1;
  2. the same mix with h = 0: the C3 twin's geometry;
  3. the script's element-window geometry: the same mix with the TPU
     window's reach, h = 8;
  4. the script's packed geometry: the 18 dye fields as one (18, X, Y)
     tensor, the velocity (2, X, Y), the 3 inflow colours (3, X, Y) and a
     mask in (4 tensors), one (18, X, Y) tensor out, h = 8;

each held to its plain version within 1e-5·max(1, |ref|max) and timed with
CUDA events, its rate beside the streaming copy's (probe C2); then A4 itself
(``cip_dye_phase_cuda`` on seeded fields of scene 2), its registered mix bytes
over its time. The verdict line reads them: if h = 1 runs close to h = 0,
the neighbour reads are free; if they cost time but h = 8 costs what h = 1
does, they hit L1/L2 (rows 8 away lie outside the 8-row thread block) and
the cost is their loads; if the cost grows with the reach, it is
device-memory traffic. If A4 runs near the h = 1 twin's rate, its geometry
is its ceiling.

    python -m fluid2d_tpu_torch.scripts.dma_geometry_bench [--res 1600] [--iters 200]
"""

from __future__ import annotations

import argparse
import json

import torch

from fluid2d_tpu_torch.bench import resolve_device
from fluid2d_tpu_torch.config import SimConfig
from fluid2d_tpu_torch.ops.cuda_phases import cip_dye_phase_cuda
from fluid2d_tpu_torch.ops.cuda_probes import (
    GeometryOperands,
    geometry_twin_cuda,
    geometry_twin_plain,
)
from fluid2d_tpu_torch.scenes.compile import get_scene
from fluid2d_tpu_torch.utils.profiling import (
    device_name,
    measure_hbm_bandwidth,
    mix_bytes,
    seconds_per_call,
)

__all__ = ["GEOMETRIES", "geometry", "bench", "main"]

TOL = 1e-5
CLOSE = 1.10  # two times within 10% of each other count as the same
CEILING_CLOSE = 0.90  # A4 at 90% or more of the h = 1 twin's rate: the geometry holds it

GEOMETRIES = {
    "dye_mix_h1": "dye-phase mix, reach h=1 (23 planes + 3 masks in / 18 out)",
    "dye_mix_h0": "dye-phase mix, reach h=0 (the C3 twin's geometry)",
    "element": "element windows: dye-phase mix, reach h=8",
    "packed": "packed + element (4 in / 1 out, an (18,X,Y) tensor, h=8)",
}


def geometry(name: str, res: int, device, seed: int = 0) -> GeometryOperands:
    """The operands of geometry `name` at the res grid (2·res × res), seeded
    normal fields and int8 masks in [-3, 3]."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, y = 2 * res, res

    def rnd(*lead):
        return torch.randn((*lead, x, y), generator=gen, device=dev)

    def mask():
        return torch.randint(-3, 4, (x, y), generator=gen, device=dev, dtype=torch.int8)

    if name == "packed":
        big, vel, bcd = rnd(18), rnd(2), rnd(3)
        ins = [*big.unbind(0), *vel.unbind(0), *bcd.unbind(0)]
        outs = list(torch.empty((18, x, y), device=dev).unbind(0))
        return GeometryOperands(ins, i8_in=[mask()], h=8, outs=outs)
    h = {"dye_mix_h1": 1, "dye_mix_h0": 0, "element": 8}[name]
    # dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, bc_dye; vel; three masks
    return GeometryOperands([rnd(3) for _ in range(7)], shared_in=list(rnd(2).unbind(0)),
                            i8_in=[mask() for _ in range(3)], n_out=6, h=h)


def _held(ops: GeometryOperands, what: str) -> float:
    got, ref = geometry_twin_cuda(ops), geometry_twin_plain(ops)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(1.0, max(float(r.abs().max()) for r in ref))
    if not err <= TOL * scale:
        msg = f"{what}: max error {err} > {TOL} * {scale}"
        raise AssertionError(msg)
    return err


def _a4_seconds(res: int, iters: int, dev) -> float:
    """Seconds a call of A4 (cip_dye_phase_cuda) on seeded fields of scene 2."""
    cfg = SimConfig.create(resolution=res)
    scene = get_scene(2, res, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(lead, scale, offset=0.0):
        return scale * torch.randn((lead, *scene.shape), generator=gen, device=dev) + offset

    args = (rnd(3, 0.5, 0.5), rnd(3, 0.5, 0.5), *(rnd(3, 0.1) for _ in range(4)), rnd(2, 0.5),
            scene, cfg.re, cfg.dt, cfg.dx)
    return seconds_per_call(lambda: cip_dye_phase_cuda(*args), iters, dev)


def bench(res: int = 1600, iters: int = 200, device="cuda") -> dict:
    """Each geometry's ms and GB/s beside the copy's, A4's, and the verdict."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        copy = measure_hbm_bandwidth(device=dev) / 1e9
    else:
        copy = measure_hbm_bandwidth(mbytes=2, iters=2, device=dev) / 1e9
    print(f"device: {device_name(dev)}")
    print(f"streaming copy (C2, 320 MB in+out): {copy:7.1f} GB/s", flush=True)
    rows = {}
    for name, label in GEOMETRIES.items():
        ops = geometry(name, res, dev)
        err = _held(ops, name)
        sec = seconds_per_call(lambda ops=ops: geometry_twin_cuda(ops), iters, dev)
        rows[name] = {"MB": ops.nbytes / 1e6, "ms": sec * 1e3, "GBps": ops.nbytes / sec / 1e9,
                      "max_abs_err": err}
        print(f"{label:62s}: {ops.nbytes / 1e6:7.1f} MB in {sec * 1e3:8.4f} ms = "
              f"{rows[name]['GBps']:7.1f} GB/s (copy {copy:.1f})", flush=True)
        del ops
    a4_bytes = mix_bytes("cip_dye_phase", 2 * res, res)
    a4 = _a4_seconds(res, iters, dev)
    rows["a4"] = {"MB": a4_bytes / 1e6, "ms": a4 * 1e3, "GBps": a4_bytes / a4 / 1e9}
    halo = rows["dye_mix_h1"]["ms"] / rows["dye_mix_h0"]["ms"]
    reach = rows["element"]["ms"] / rows["dye_mix_h1"]["ms"]
    share = rows["a4"]["GBps"] / rows["dye_mix_h1"]["GBps"]
    verdict = f"h=1 takes {halo:.3f}× the h=0 time and h=8 {reach:.3f}× the h=1 time: "
    if halo < CLOSE:
        verdict += "the neighbour reads are nearly free; "
    elif reach < CLOSE:
        verdict += "the neighbour reads hit L1/L2 (the reach does not matter) but their loads cost; "
    else:
        verdict += "the cost grows with the reach: device-memory traffic; "
    verdict += f"A4 runs at {100 * share:.1f}% of the h=1 twin's rate: "
    verdict += ("its geometry is its ceiling" if share >= CEILING_CLOSE else
             "the rest of its time is its four stages' own traffic and work")
    print(f"{'A4 cip_dye_phase kernel (its registered mix bytes)':62s}: "
          f"{a4_bytes / 1e6:7.1f} MB in {a4 * 1e3:8.4f} ms = {rows['a4']['GBps']:7.1f} GB/s "
          f"(copy {copy:.1f})")
    print(f"verdict: {verdict}", flush=True)
    return {"device": device_name(dev), "res": res, "copy_GBps": copy, **rows,
            "h1_over_h0": halo, "h8_over_h1": reach, "a4_over_h1_twin": share, "verdict": verdict}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--res", type=int, default=1600)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(bench(args.res, args.iters, args.device)))


if __name__ == "__main__":
    main()
