"""Time the CIP phase kernels (A3 velocity, A4 dye) and the headline step.

    python -m fluid2d_tpu_torch.scripts.cip_phase_bench [--res 1600] [--calls 20]
        [--steps 200] [--json PATH]

A3 and A4 at float32 and bf16 on seeded fields of scene 2 at the res grid
(2·res × res), each the median of `calls` CUDA-event calls as
``chip_smoke.py`` times a kernel; beside them the C3 twins of their
operand mixes (``mix_twin``, the same bytes read once at reach 0) and the
C5f dye-mix twin at reach 1; the kernels that share the phases' per-cell
functions at float32 (C1's dye form, B2 and B3 upwind); then the headline
steps/s (``bench.bench_config``: res CIP, scene 2, f32 and bf16). Each
kernel's bound is ``chip_smoke.py``'s (its kernels line).
It calls only entry points the package had before the phases were fused, so
another tree's package is timed by the same file, parent against change in
one card call: ``PYTHONPATH=<tree> python <this file>``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from fluid2d_tpu_torch import SimConfig, get_scene, scene_for_dtype
from fluid2d_tpu_torch.bench import bench_config, resolve_device
from fluid2d_tpu_torch.ops import cuda_phases, cuda_probes, cuda_stencil
from fluid2d_tpu_torch.utils import profiling

__all__ = ["phase_calls", "shared_calls", "time_phases", "main"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def median_ms(fn, calls: int) -> float:
    """Median device time of one call over `calls` calls (CUDA events), after
    two warm-up calls: chip_smoke.py's median_ms, so that the two scripts'
    times compare (this file must also run against a tree without it)."""
    fn()
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_calls(res: int, dtype: torch.dtype, dev) -> dict[str, tuple]:
    """{name: (wrapper, plain version, args)} for A3 and A4 on seeded fields
    of scene 2 at `dtype`, the inputs of chip_smoke.py's kernel phase."""
    cfg = SimConfig.create(resolution=res, dtype=str(dtype).removeprefix("torch."))
    scene = scene_for_dtype(get_scene(2, res, dev), cfg)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(lead, scale, offset=0.0):
        t = scale * torch.randn((*lead, *scene.shape), generator=gen, device=dev) + offset
        return t.to(dtype)

    p, v, va = rnd((), 0.3), rnd((2,), 0.5), rnd((2,), 0.5)
    vg = [rnd((2,), 0.1) for _ in range(4)]
    dye, da = rnd((3,), 0.5, 0.5), rnd((3,), 0.5, 0.5)
    dg = [rnd((3,), 0.1) for _ in range(4)]
    consts = (cfg.re, cfg.dt, cfg.dx)
    return {
        "cip_velocity_phase": (cuda_phases.cip_velocity_phase_cuda,
                               cuda_phases.cip_velocity_phase_plain,
                               (v, p, va, *vg, scene, *consts)),
        "cip_dye_phase": (cuda_phases.cip_dye_phase_cuda, cuda_phases.cip_dye_phase_plain,
                          (dye, da, *dg, v, scene, *consts)),
    }


def shared_calls(res: int, dev) -> dict[str, tuple]:
    """{name: (wrapper, args)} at float32 for the kernels that share the
    phases' per-cell functions: C1 (its dye form) and B2, B3 (upwind)."""
    cfg = SimConfig.create(resolution=res)
    scene = get_scene(2, res, dev)
    gen = torch.Generator(device=dev).manual_seed(4321)

    def rnd(lead, scale, offset=0.0):
        return scale * torch.randn((*lead, *scene.shape), generator=gen, device=dev) + offset

    p, v, dye = rnd((), 0.3), rnd((2,), 0.5), rnd((3,), 0.5, 0.5)
    return {
        "cip_advect": (cuda_stencil.cip_advect_cuda,
                       (dye, rnd((3,), 0.1), rnd((3,), 0.1), v, *(rnd((3,), 0.5) for _ in range(3)),
                        scene.fluid8, cfg.dt, cfg.dx)),
        "mac_velocity_phase_upwind": (cuda_phases.mac_velocity_phase_cuda,
                                      (v, p, rnd((2,), 0.5), scene, "upwind", cfg.re, cfg.dt,
                                       cfg.dx)),
        "mac_dye_phase_upwind": (cuda_phases.mac_dye_phase_cuda,
                                 (dye, rnd((3,), 0.5, 0.5), v, scene, "upwind", cfg.dt, cfg.dx)),
    }


def time_phases(res: int, calls: int, dev) -> dict:
    """A3 and A4 at both dtypes: ms a call."""
    return {f"{name}_{dname}": median_ms(lambda wrapper=wrapper, args=args: wrapper(*args), calls)
            for dname, dtype in DTYPES.items()
            for name, (wrapper, _, args) in phase_calls(res, dtype, dev).items()}


def twin_ms(res: int, calls: int, dev) -> dict:
    """The C3 twins of the two phase mixes at both dtypes and the C5f dye-mix
    twin at reach 1 (float32)."""
    from fluid2d_tpu_torch.scripts import dma_geometry_bench

    out = {}
    for dname, dtype in DTYPES.items():
        for mix in ("cip_velocity_phase", "cip_dye_phase"):
            ops = profiling.twin_operands(mix, 2 * res, res, dev, dtype)
            out[f"c3_{mix}_{dname}"] = median_ms(lambda ops=ops: cuda_probes.mix_twin_cuda(ops),
                                                 calls)
            del ops
    ops = dma_geometry_bench.geometry("dye_mix_h1", res, dev)
    out["c5f_dye_mix_h1_float32"] = median_ms(lambda: cuda_probes.geometry_twin_cuda(ops), calls)
    return out


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=1600)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    result = {"device": smi_line(), "res": args.res}
    print(result["device"], flush=True)
    result["phases_ms"] = time_phases(args.res, args.calls, dev)
    result["shared_ms"] = {name: median_ms(lambda fn=fn, a=a: fn(*a), args.calls)
                           for name, (fn, a) in shared_calls(args.res, dev).items()}
    result["twins_ms"] = twin_ms(args.res, args.calls, dev)
    result["headline_steps_per_s"] = {
        dname: bench_config(args.res, "cip", args.steps, dtype=dname, device=dev)[0]
        for dname in DTYPES}
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
