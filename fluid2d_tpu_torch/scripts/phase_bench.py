"""Time the fused kernels and the headline step, one tree or several in turn.

    python -m fluid2d_tpu_torch.scripts.phase_bench [--res 1600] [--calls 20]
        [--steps 200] [--json PATH] [--trees DIR [DIR ...]] [--probes-only | --shared-only]

At float32 and bf16, on seeded fields of scene 2 at the res grid (2·res ×
res), each the median of `calls` CUDA-event calls as ``chip_smoke.py`` times a
kernel:
  sor_pair            A1: a step's pressure solve, ``update_pressure_and_limit``
                      at the default 2 SOR iterations with the limiter
  confinement         A2
  cip_velocity_phase  A3
  cip_dye_phase       A4
  jacobi_n2           B1: two Jacobi iterations with the limiter, one call
  jacobi_n4           B1: four Jacobi iterations, one call (the first call of
                      a six-iteration solve)
then, at both dtypes, the kernels that share the phases' per-cell functions
(C1's dye form and velocity form, B2 and B3 upwind and KK); the C5a
dtype-rate chains (``rate_ms``: the fma mode at RATE_PASSES passes on
(2048, 1024) elements, as ``chip_smoke.py`` times it, beside its operation
bound ``rate_bound_ms``); the C3 twins of the mixes the
tree registers (``mix_twin``: the same bytes read once at reach 0) and the
C5f dye-mix twin at reach 1; the probes, each beside the one PyTorch call of
the same function on the same float32 plane (``probes_ms``), the plane
(2·res, res) but where said:
  toy_div3, toy_mul3  C6: x/3 and x·3 (``torch.div``, ``torch.mul`` with out=)
  row_window          C5g at ``row_window_tile``'s t (``torch.mul(a, 2.0, out=o)``)
  row_window_no_tail  C5g on (2·t·SMs, res): two tiles for each persistent
                      block at res=1600 (one block an SM), so no block idles
                      while others take a last tile
  row_copy_tail_<dtype>  C5b's tail copy of rows [8, 24) of a (256, 256)
                      float32 or bf16 plane to float32
                      (``out.copy_(x[8:24])``, which widens bf16 too)
and the steps/s (scene 2, both dtypes) of the headline (res CIP), of the
MAC schemes (res upwind and KK; ``bench.bench_config``), of the Jacobi
solver (res CIP with 2 and 6 Jacobi iterations) and of presets 1 and 2
(``bench.run_preset``). Each kernel's
bound is the bytes its function needs on the scene
(``utils/profiling.py:needed_bytes``: the registered mix's, with each
alternate and scene constant counted at the cells that read it) at the card's
published rate (``HBM_BYTES_PER_S``); the whole mix's bound stands beside it.
A probe's bound (``<name>_bound``) is its input read once and its output
written once.
``--probes-only``
times the probes and the C5a chains alone (a sweep of probe variants);
``--shared-only`` the kernels that share the phases' per-cell functions
(``shared_ms``) and the C5a chains alone (a sweep of their variants).

With ``--trees``, each tree's package is timed in a process of its own
(``PYTHONPATH=<tree>``), in the order given, so parent against change in one
card call is ``--trees <parent> . . <parent>``; the bounds are this tree's.
Such a process calls only entry points the package had before SOR and
confinement were fused.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from fluid2d_tpu_torch import SimConfig, get_scene, init_state, make_run_fn, scene_for_dtype
from fluid2d_tpu_torch.bench import bench_config, run_preset
from fluid2d_tpu_torch.config import resolve_device
from fluid2d_tpu_torch.models.common import update_pressure_and_limit
from fluid2d_tpu_torch.ops import cuda_dtype_probes, cuda_phases, cuda_probes, cuda_stencil
from fluid2d_tpu_torch.utils import profiling

__all__ = ["median_ms", "phase_calls", "probe_calls", "shared_calls", "time_phases", "BOUND_MIX",
           "main"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Each timed call's registered operand mix, from which its bound is taken.
BOUND_MIX = {"sor_pair": "sor_iteration_n2_v_limit", "confinement": "confinement",
             "cip_velocity_phase": "cip_velocity_phase", "cip_dye_phase": "cip_dye_phase",
             "jacobi_n2": "jacobi_iteration_n2_v_limit", "jacobi_n4": "jacobi_iteration_n4",
             "cip_advect": "cip_advect", "cip_advect_self": "cip_advect_self",
             "mac_velocity_phase_upwind": "mac_velocity_phase_upwind",
             "mac_velocity_phase_kk": "mac_velocity_phase_kk",
             "mac_dye_phase_upwind": "mac_dye_phase_upwind",
             "mac_dye_phase_kk": "mac_dye_phase_kk"}
TWIN_MIXES = ("cip_velocity_phase", "cip_dye_phase", "sor_iteration_n2_v_limit", "confinement",
              "jacobi_iteration_n2_v_limit")
TIMED_CALLS = 20
RATE_SHAPE, RATE_PASSES = (2048, 1024), 3072  # C5a's timed inputs and depth
SPIN_CYCLES = 2_000_000  # ~1 ms of the card's clock: longer than a call's enqueue


def median_ms(fn, calls: int = TIMED_CALLS) -> float:
    """Median device time of one call over `calls` calls (CUDA events), after
    two warm-up calls; ``chip_smoke.py`` times its kernels with it too. A
    spin kernel holds the stream while each call is enqueued, so a kernel
    shorter than the host's enqueue (a wrapper takes ~50–95 µs) is timed
    alone, not with the host's time."""
    fn()
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_calls(res: int, dtype: torch.dtype, dev) -> dict[str, tuple]:
    """{name: (wrapper, plain version, args)} for A1's step pair, A2, A3, A4
    and B1 (two iterations with the limiter, four without) on seeded fields
    of scene 2 at `dtype`, the inputs of
    chip_smoke.py's kernel phase."""
    dname = str(dtype).removeprefix("torch.")
    cfg = SimConfig.create(resolution=res, dtype=dname)
    eager = SimConfig.create(resolution=res, dtype=dname, kernels="eager")
    scene = scene_for_dtype(get_scene(2, res, dev), cfg)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(lead, scale, offset=0.0):
        t = scale * torch.randn((*lead, *scene.shape), generator=gen, device=dev) + offset
        return t.to(dtype)

    p, pa, v, va = rnd((), 0.3), rnd((), 0.3), rnd((2,), 0.5), rnd((2,), 0.5)
    vg = [rnd((2,), 0.1) for _ in range(4)]
    dye, da = rnd((3,), 0.5, 0.5), rnd((3,), 0.5, 0.5)
    dg = [rnd((3,), 0.1) for _ in range(4)]
    fast = rnd((2,), 8.0)  # |v| straddles the limit of 10
    consts = (cfg.re, cfg.dt, cfg.dx)
    jacobi = functools.partial(cuda_stencil.jacobi_iteration_cuda, n_iters=2,
                               v_limit=cfg.velocity_limit)
    jacobi_plain = functools.partial(cuda_stencil.jacobi_iteration_plain, n_iters=2,
                                     v_limit=cfg.velocity_limit)
    jargs = (p, pa, fast[0], fast[1], scene.pbc_code, scene.not_wall8, cfg.dt, cfg.dx)
    return {
        "sor_pair": (functools.partial(update_pressure_and_limit, cfg=cfg),
                     functools.partial(update_pressure_and_limit, cfg=eager),
                     (p, pa, fast, scene)),
        "confinement": (cuda_phases.confinement_cuda, cuda_phases.confinement_plain,
                        (v, va, scene.fluid8, cfg.dt, cfg.vor_eps, cfg.dx)),
        "cip_velocity_phase": (cuda_phases.cip_velocity_phase_cuda,
                               cuda_phases.cip_velocity_phase_plain,
                               (v, p, va, *vg, scene, *consts)),
        "cip_dye_phase": (cuda_phases.cip_dye_phase_cuda, cuda_phases.cip_dye_phase_plain,
                          (dye, da, *dg, v, scene, *consts)),
        "jacobi_n2": (jacobi, jacobi_plain, jargs),
        "jacobi_n4": (functools.partial(cuda_stencil.jacobi_iteration_cuda, n_iters=4),
                      functools.partial(cuda_stencil.jacobi_iteration_plain, n_iters=4), jargs),
    }


def shared_calls(res: int, dev, dtype: torch.dtype = torch.float32) -> dict[str, tuple]:
    """{name: (wrapper, args)} at `dtype` for the kernels that share the
    phases' per-cell functions: C1 (its dye form, and its velocity form,
    ``vel is f``), B2 and B3 (upwind and KK)."""
    dname = str(dtype).removeprefix("torch.")
    cfg = SimConfig.create(resolution=res, dtype=dname)
    scene = scene_for_dtype(get_scene(2, res, dev), cfg)
    gen = torch.Generator(device=dev).manual_seed(4321)

    def rnd(lead, scale, offset=0.0):
        t = scale * torch.randn((*lead, *scene.shape), generator=gen, device=dev) + offset
        return t.to(dtype)

    p, v, dye = rnd((), 0.3), rnd((2,), 0.5), rnd((3,), 0.5, 0.5)
    return {
        "cip_advect": (cuda_stencil.cip_advect_cuda,
                       (dye, rnd((3,), 0.1), rnd((3,), 0.1), v, *(rnd((3,), 0.5) for _ in range(3)),
                        scene.fluid8, cfg.dt, cfg.dx)),
        **{f"mac_velocity_phase_{scheme}": (cuda_phases.mac_velocity_phase_cuda,
                                            (v, p, rnd((2,), 0.5), scene, scheme, cfg.re,
                                             cfg.dt, cfg.dx))
           for scheme in ("upwind", "kk")},
        **{f"mac_dye_phase_{scheme}": (cuda_phases.mac_dye_phase_cuda,
                                       (dye, rnd((3,), 0.5, 0.5), v, scene, scheme, cfg.dt,
                                        cfg.dx))
           for scheme in ("upwind", "kk")},
        "cip_advect_self": (cuda_stencil.cip_advect_cuda,
                            (v, rnd((2,), 0.1), rnd((2,), 0.1), v, rnd((2,), 0.5),
                             rnd((2,), 0.1), rnd((2,), 0.1), scene.fluid8, cfg.dt, cfg.dx)),
    }


def probe_calls(res: int, dev) -> dict[str, tuple]:
    """{name: (wrapper call, library call, bytes)} for the probes: the
    streaming ones on seeded float32 planes, (2·res, res) but for
    ``row_window_no_tail``'s (2·t·SMs, res), and C5b's tail copy at both
    dtypes on chip_smoke.py's (256, 256) plane; the library call writes into
    a preallocated output, as the wrapper's own allocation is not the
    function. The bytes: the input read once and the output written once."""
    gen = torch.Generator(device=dev).manual_seed(97)
    t = cuda_probes.row_window_tile(2 * res, res)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x = torch.randn((2 * res, res), generator=gen, device=dev)
    y = torch.randn((2 * t * sms, res), generator=gen, device=dev)
    o, p = torch.empty_like(x), torch.empty_like(y)
    calls = {
        "toy_div3": (lambda: cuda_probes.toy_elementwise_cuda(x, "div3"),
                     lambda: torch.div(x, 3.0, out=o), 2 * x.nbytes),
        "toy_mul3": (lambda: cuda_probes.toy_elementwise_cuda(x, "mul3"),
                     lambda: torch.mul(x, 3.0, out=o), 2 * x.nbytes),
        "row_window": (lambda: cuda_probes.row_window_cuda(x, t),
                       lambda: torch.mul(x, 2.0, out=o), 2 * x.nbytes),
        "row_window_no_tail": (lambda: cuda_probes.row_window_cuda(y, t),
                               lambda: torch.mul(y, 2.0, out=p), 2 * y.nbytes),
    }
    oc = torch.empty((16, 256), device=dev)
    for dname, dtype in DTYPES.items():
        xc = (torch.arange(256 * 256, dtype=torch.float32, device=dev).reshape(256, 256)
              * 1e-4).to(dtype)
        calls[f"row_copy_tail_{dname}"] = (
            lambda xc=xc: cuda_dtype_probes.row_copy_cuda(xc, "tail"),
            lambda xc=xc: oc.copy_(xc[8:24]), xc[8:24].nbytes + oc.nbytes)
    return calls


def probe_ms(res: int, calls: int, dev) -> dict:
    """Each probe's ms, its library call's (``<name>_library``) and its
    bound (``<name>_bound``: its bytes at the published rate);
    ``row_window_no_tail_rows``: that plane's rows."""
    out = {}
    for name, (kernel, library, nbytes) in probe_calls(res, dev).items():
        out[name] = median_ms(kernel, calls)
        out[f"{name}_library"] = median_ms(library, calls)
        out[f"{name}_bound"] = nbytes / profiling.HBM_BYTES_PER_S * 1e3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out["row_window_no_tail_rows"] = 2 * cuda_probes.row_window_tile(2 * res, res) * sms
    return out


def rate_ms(calls: int, dev) -> dict:
    """C5a's fma chains at RATE_PASSES on seeded RATE_SHAPE inputs, ms a
    call at each dtype."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    x = 2.0 + torch.rand(RATE_SHAPE, generator=gen, device=dev)
    return {dname: median_ms(lambda xd=x.to(dtype): cuda_dtype_probes.dtype_rate_cuda(
                xd, RATE_PASSES, "fma"), calls)
            for dname, dtype in DTYPES.items()}


def rate_bound_ms(dtype: torch.dtype) -> float:
    """C5a's operation bound (ms): 2 flops an element a pass at the float32
    rate, bf16 two lanes an instruction (half the time)."""
    lanes = 1 if dtype == torch.float32 else 2
    flops = 2 * RATE_SHAPE[0] * RATE_SHAPE[1] * RATE_PASSES / lanes
    return flops / profiling.FP32_FLOPS_PER_S * 1e3


def time_phases(res: int, calls: int, dev) -> dict:
    """The phase calls at both dtypes: ms a call."""
    return {f"{name}_{dname}": median_ms(lambda wrapper=wrapper, args=args: wrapper(*args), calls)
            for dname, dtype in DTYPES.items()
            for name, (wrapper, _, args) in phase_calls(res, dtype, dev).items()}


def twin_ms(res: int, calls: int, dev) -> dict:
    """The C3 twins of the mixes of TWIN_MIXES that the package registers, at
    both dtypes, and the C5f dye-mix twin at reach 1 (float32)."""
    from fluid2d_tpu_torch.scripts import dma_geometry_bench

    out = {}
    for dname, dtype in DTYPES.items():
        for mix in TWIN_MIXES:
            if mix not in profiling._KERNEL_MIXES:
                continue
            ops = profiling.twin_operands(mix, 2 * res, res, dev, dtype)
            out[f"c3_{mix}_{dname}"] = median_ms(lambda ops=ops: cuda_probes.mix_twin_cuda(ops),
                                                 calls)
            del ops
    ops = dma_geometry_bench.geometry("dye_mix_h1", res, dev)
    out["c5f_dye_mix_h1_float32"] = median_ms(lambda: cuda_probes.geometry_twin_cuda(ops), calls)
    return out


def jacobi_steps_per_s(res: int, n_iters: int, steps: int, dtype: str, dev) -> float:
    """Steps/s of res CIP on scene 2 with `n_iters` Jacobi iterations, timed
    as ``bench.bench_config`` times a configuration."""
    cfg = SimConfig.create(resolution=res, pressure_solver="jacobi", n_pressure_iter=n_iters,
                           dtype=dtype)
    scene = scene_for_dtype(get_scene(2, res, dev), cfg)
    sec_per_step, _ = profiling.time_steps(make_run_fn(cfg), init_state(scene, cfg, dev), scene,
                                           steps)
    return 1.0 / sec_per_step


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def measure(res: int, calls: int, steps: int, only: str | None = None) -> dict:
    """Every time of one tree (with `only` "probes" or "shared", those and
    the C5a chains alone), in this process."""
    dev = resolve_device("cuda")
    result = {"device": smi_line(), "res": res, "rate_ms": rate_ms(calls, dev)}
    if only != "shared":
        result["probes_ms"] = probe_ms(res, calls, dev)
    if only != "probes":
        result["shared_ms"] = {f"{name}_{dname}": median_ms(lambda fn=fn, a=a: fn(*a), calls)
                               for dname, dtype in DTYPES.items()
                               for name, (fn, a) in shared_calls(res, dev, dtype).items()}
    if only is not None:
        return result
    result["phases_ms"] = time_phases(res, calls, dev)
    result["twins_ms"] = twin_ms(res, calls, dev)
    result["headline_steps_per_s"] = {
        dname: bench_config(res, "cip", steps, dtype=dname, device=dev)[0] for dname in DTYPES}
    result["mac_steps_per_s"] = {
        f"{scheme}_{dname}": bench_config(res, scheme, steps, dtype=dname, device=dev)[0]
        for scheme in ("upwind", "kk") for dname in DTYPES}
    result["jacobi_steps_per_s"] = {
        f"cip_jacobi{n}_{dname}": jacobi_steps_per_s(res, n, steps, dname, dev)
        for n in (2, 6) for dname in DTYPES}
    result["preset_steps_per_s"] = {f"preset{n}_{dname}": run_preset(n, dname)["value"]
                                    for n in (1, 2) for dname in DTYPES}
    return result


def bounds_ms(res: int) -> dict:
    """Each timed call's bound at both dtypes (ms at the published rate):
    ``bound_ms`` from the bytes its function needs on scene 2,
    ``ledger_bound_ms`` from its whole mix."""
    scene = get_scene(2, res, "cpu")
    out = {"bound_ms": {}, "ledger_bound_ms": {},
           "rate_bound_ms": {dname: rate_bound_ms(dtype) for dname, dtype in DTYPES.items()}}
    for name, mix in BOUND_MIX.items():
        for dname, dtype in DTYPES.items():
            for key, nbytes in (("bound_ms", profiling.needed_bytes(mix, scene, dtype.itemsize)),
                                ("ledger_bound_ms",
                                 profiling.mix_bytes(mix, *scene.shape, dtype.itemsize))):
                out[key][f"{name}_{dname}"] = nbytes / profiling.HBM_BYTES_PER_S * 1e3
    return out


def run_tree(tree: str, args) -> dict:
    """measure() for the package of `tree`, in a process of its own."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--times-only", "--res", str(args.res),
           "--calls", str(args.calls), "--steps", str(args.steps)]
    if args.only:
        cmd.append(f"--{args.only}-only")
    env = {**os.environ, "PYTHONPATH": str(Path(tree).resolve())}
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        msg = f"phase_bench in {tree}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}"
        raise RuntimeError(msg)
    return {"tree": tree, **json.loads(proc.stdout.strip().splitlines()[-1])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=1600)
    ap.add_argument("--calls", type=int, default=TIMED_CALLS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--json", default=None)
    ap.add_argument("--trees", nargs="+", default=None,
                    help="time each tree's package in turn (a process each)")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--probes-only", action="store_const", const="probes", dest="only",
                      help="time the streaming probes and the C5a chains alone")
    only.add_argument("--shared-only", action="store_const", const="shared", dest="only",
                      help="time C1, B2, B3 and the C5a chains alone")
    ap.add_argument("--times-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.times_only:
        result = measure(args.res, args.calls, args.steps, args.only)
    else:
        resolve_device("cuda")
        runs = ([run_tree(tree, args) for tree in args.trees] if args.trees
                else [measure(args.res, args.calls, args.steps, args.only)])
        result = {"device": smi_line(), "res": args.res, **bounds_ms(args.res), "runs": runs}
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
