#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one CUDA card, and check them.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc. The
paths are scene 2 at res=1600 (a 3200×1600 grid) with 3-channel dye,
vorticity confinement ε=5 and velocity limit 10:

  cip          CIP advection, red-black SOR (ω=1.3, 2 iterations) — the main path
  upwind, kk   the MAC step with upwind / Kawamura-Kuwahara advection, SOR
  cip_jacobi2  CIP with the Jacobi solver, 2 iterations (one kernel run)
  cip_jacobi6  CIP with the Jacobi solver, 6 iterations (runs of 4, then 2)

with float32 state, the same four first paths with bf16 state (cip_bf16,
upwind_bf16, kk_bf16, cip_jacobi2_bf16: stored in bf16, arithmetic float32),
and the six presets of the port's bench (fluid2d_tpu_torch/bench.py:_PRESETS,
the JAX package's bench.py presets), each at its own scene, resolution, Re,
dt and ε: scenes 1, 2, 3, 5 and 6, res 400 to 4096 (an 8192×4096 grid).
Phases, each printed as JSON lines:

1. device  — the card; nvidia-smi's "name, power.limit" line is printed as is.
2. build   — nvcc builds fluid2d_tpu_torch/csrc/*.cu (one process per source);
             seconds taken.
3. kernels — each kernel (and each variant: scheme, iterations, limiter;
             the standalone CIP advection C1 in its dye form, 3 channels by
             a given velocity, and its velocity form, 2 channels, vel is f)
             against its plain PyTorch version at the res=1600 shapes on
             seeded random inputs: at float32 every output within
             1e-5·max(1, |ref|max) (in fact 0.0), the fused kernels (every
             phase kernel: the CIP and MAC phases, SOR, Jacobi,
             confinement; and C1: BIT_EQUAL_F32) bit-equal; at bf16
             every variant (SOR: one and two iterations, with and without
             the limiter) and
             every pressure chain link (bf16→f32, f32→f32, f32→bf16,
             bf16→bf16) bit-equal, a NaN equal to any NaN; median ms of both
             over 20 calls (CUDA events, behind a spin kernel:
             scripts/phase_bench.py:median_ms). The registry check: the bytes each
             variant logs in the byte ledger equal its registered operand mix
             (utils/profiling.py:mix_bytes, at the transport dtype's itemsize).
             The bound: the larger of the bytes the function needs at 3.35
             TB/s and the plain version's counted el-ops at 67 TFLOP/s (H100
             SXM, float32 outside the tensor cores); the bytes are the
             ledger's with each alternate and scene constant counted only at
             the cells that read it (profiling.needed_bytes, on this scene);
             ledger_bound_ms, the same with the whole ledger, beside it.
   probes  — the roofline's probes against their plain versions: the copy
             (C2) bit-equal on the 320 MB working set, beside
             torch.add(x, 1, out=o); the mix twin (C3) of every registered
             mix at the res=1600 grid within 1e-5 at float32 and bit-equal at
             bf16 (C5c); the FMA chains (C4) at 64 passes within 1e-5 and at
             the timed 8192 passes within the rounding bound of the float64
             plain version, with a one-round-short negative control; the
             dtype-rate chains (C5a) on the timed (2048, 1024) inputs, per
             mode and dtype within RATE_TOL_ULPS of their plain version at 48
             passes, a step more or fewer missing it at every element, and
             the timed fma chains at 3072 passes within RATE_TOL_ULPS too;
             the row copies (C5b) bit-equal, the tail copy timed beside
             out.copy_(x[8:8+t]) (the one PyTorch call of its function,
             which widens bf16 too). The C3 twin covers C1's two
             registered mixes (cip_advect, cip_advect_self).
4. parity  — per path (presets and bf16 paths included), a seeded smooth
             state, 4 steps with kernels="cuda" and with kernels="eager" on
             the card: every state leaf within 2e-5·max(1, |ref|max) at
             float32 and bit-equal at bf16; each kernel counter moved by
             exactly its runs per step (RUNS_PER_STEP) times 4, and by 0 on
             the eager path.
   profile — torch.profiler over two headline steps at float32 and at bf16:
             the CUDA kernels are the port's, the same at both dtypes but for
             their template arguments, plus the step counter's one-element
             add; no copy or convert kernel; exactly one fused kernel a CIP
             phase, SOR and confinement call (PROFILE_COUNTS: one SOR call a
             step runs both iterations), none of the launches they replaced,
             and no standalone advection. Then over two kk steps at float32
             (KK_PROFILE_COUNTS): one fused launch a MAC velocity and a MAC
             dye phase call and none of the two launches each replaced,
             SOR's and confinement's one; and over two cip_jacobi2 steps
             (JACOBI_PROFILE_COUNTS): one fused launch a Jacobi call and
             none of the BC and sweep launches it replaced. A host's
             profiler may drop a
             launch from a trace: a trace that holds only expected kernels
             but too few of them is taken again, up to PROFILE_TRACES in
             all, and the phase fails if none is whole (an empty trace
             included). A foreign kernel or a launch too many fails at once.
5. run     — FluidSimulator.create(bc_num=2, resolution=1600, device="cuda")
             for cip, upwind, kk, cip_jacobi2 and cip_bf16: 2 warm-up steps,
             RUN_STEPS timed steps ending in a synchronize and a device→host
             read; every leaf finite; the counters as in 4; steps/s, beside
             the eager path's steps/s over 20 steps.
6. bench   — the port's bench entry points: bench_config for the headline
             (res=1600 CIP, after a warm-up of the same steps) and run_preset
             for presets 1–6, at float32 and at bf16; each must be stable and
             move each kernel counter by exactly its runs per step times its
             2n steps.
7. roofline — roofline_report (the path of `bench --roofline`) for cip and kk
             at float32 and cip at bf16, res=1600: the copy bandwidth > 0 and
             at most the published 3.35 TB/s, a ceiling and a floor for every
             kernel, the share of the geometry roofline at most 100%; the
             probes C2–C4 must have launched.
8. bf16 probes — the port's probe scripts through their entry points:
             vpu_dtype_probe (C5a, each mode, held to its plain version on
             its timed inputs at 48 passes and at 3072; the fma mode's
             float32 and bf16 ms each printed with its share of the
             operation bound), bf16_dma_probe (C5b, a FAIL
             raises) and bf16_geometry_probe (C5c).
9. last probes — C1 at the op level (cip_advect_cuda, both forms, float32
             and bf16, finite outputs of the input's shape and dtype) and the
             last probe scripts through their entry points: the whole
             vpu_rate_sweep (C5d, its own checks: every chain count and depth
             within fma_rate_error_bound, one round short beyond it),
             dma_geometry_sweep --only incount,triples,outs,bigcopy (C5e,
             each case within 1e-5 of its plain version), dma_geometry_bench
             (C5f) and dma_rowwin_1600_check at Y=1600 (C5g, must print OK),
             and the el-op toys (C6) at (32, 128), (8, 128) and 3200×1600.
             Then, with the counts read, each new kernel held to its plain
             version on the inputs it times, and timed as phase 3 times
             (median_ms, behind a spin kernel), beside its library call
             where one PyTorch call computes the function: C1's four calls
             bit-equal, each ms beside its bound (the bytes its form needs);
             the sweep's
             8-chain case within its bound, with the one-round-short
             control; the geometry twin within 1e-5 at h = 0, 1 and 8, with
             channels; the row window bit-equal to 2·a and to its plain
             version; the three toys bit-equal at the three shapes and on a
             view at offset 1 of the largest (the kernel's scalar path), with
             the el-op counter's counts of their plain versions. Last the
             view's 8-bit image (V1) on random frames with NaN and ±inf at
             3200×1600 and 800×400, bit-equal to the NumPy path of
             utils/viz.py:to_image and to its plain version, each timed
             beside its bound (15 bytes a cell), its plain version and the
             PyTorch clamp, multiply, add and cast of the same frame.
10. front end — the CLI in this process (cli.main, the counters read around
             each run), at the main path's full width (scene 2, res=1600,
             CIP, SOR ω=1.3 ×2, ε=5, dye) at float32 and at bf16: run A, 21
             steps with a frame and a log line every 10, a dump and a
             checkpoint; run B, --resume A for 9 steps with a dump (named
             step_000030.npz) and a checkpoint; run C, 30 straight steps of
             FluidSimulator.create. B's state (read back from its
             checkpoint) bit-equal to C's on every leaf; A and B each launch
             A1–A4 once a step (RUNS_PER_STEP["cip"]) and A the image
             kernel V1 once a frame; two frames of
             3200×1600, not uniform; the log lines carry div_rms and no NaN;
             C's four views rendered on the card within VIEW_TOL of the same
             state rendered on the CPU, and their 8-bit images from the card
             (V1) bit-equal to the NumPy path's. The CLI timed with frames and logs
             off (HEADLINE_STEPS steps) beside phase 6's headline, at least
             CLI_RATE_FLOOR of it. Then solver_residual_bench (SOLVER_ARGS;
             A1 and B1 with A2–A4, each kernel's runs counted from the
             pressure chain) and bf16_drift (DRIFT_ARGS, both dtypes, no NaN)
             through their entry points. The files live in a temporary
             directory (an f32 checkpoint at res=1600 is about 655 MB).

Then the kernel table as one JSON line (launches summed over phases 5–10),
and as the last line {"ok": true, "device": {...}}. Any failure raises: the
exit code is not 0 and the last line is not printed. Without a CUDA card it
exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from fluid2d_tpu_torch import (
    FluidSimulator,
    SimConfig,
    bench,
    cli,
    get_scene,
    init_state,
    make_run_fn,
    scene_for_dtype,
)
from fluid2d_tpu_torch.ops import (
    _build,
    cuda_dtype_probes,
    cuda_phases,
    cuda_probes,
    cuda_stencil,
    cuda_view,
    launch,
)
from fluid2d_tpu_torch.convert import state_from_numpy, state_to_numpy
from fluid2d_tpu_torch.models.common import pressure_chain
from fluid2d_tpu_torch.scenes.compile import Scene
from fluid2d_tpu_torch.scripts import (
    bf16_dma_probe,
    bf16_drift,
    bf16_geometry_probe,
    dma_geometry_bench,
    dma_geometry_sweep,
    dma_rowwin_1600_check,
    solver_residual_bench,
    vpu_dtype_probe,
    vpu_rate_sweep,
)
from fluid2d_tpu_torch.scripts.phase_bench import median_ms
from fluid2d_tpu_torch.utils import io as fio
from fluid2d_tpu_torch.utils import profiling
from fluid2d_tpu_torch.utils.trace import entry_launches, launches as launch_counter
from fluid2d_tpu_torch.utils.viz import render_rgb, to_image

RES = 1600
SCENE = 2
BF16 = torch.bfloat16
KERNEL_TOL = 1e-5
STEP_TOL = 2e-5
PARITY_STEPS = 4
RUN_STEPS = 100
WARMUP_STEPS = 2
EAGER_STEPS = 20
HEADLINE_STEPS = 200
PLAIN_FMA_CALLS = 3  # the plain FMA chains at full depth take ~0.2 s a call
FMA_CHECK_PASSES = 64
FMA_PASSES = 8192
RATE_PASSES = 3072  # the dtype-rate probe's timed depth
ROOFLINE_STEPS = 100
PROFILE_TRACES = 3  # traces of two headline steps the profile phase may take
PUBLISHED_GBPS = profiling.HBM_BYTES_PER_S / 1e9
# Phase 10, the front end: the CLI's flags for the main path (its defaults
# are CIP, SOR ω=1.3 ×2, ε=5, dye), run A's and run B's steps (odd, so the
# run loop's one-step remainder is crossed), the frame and log interval, the
# card's views against the CPU's, the CLI's timed run against phase 6's
# headline (at least CLI_RATE_FLOOR of it: more host work on the step is a
# fault), the study scripts' arguments.
CLI_FLAGS = ["-bc", str(SCENE), "-res", str(RES)]
CLI_STEPS_A, CLI_STEPS_B, CLI_EVERY = 21, 9, 10
VIEW_TOL = 1e-6
CLI_RATE_FLOOR = 0.8
SOLVER_ARGS = {"res": RES, "iters": (2, 4), "settle": 20, "probe": 5, "steps": 50}
DRIFT_ARGS = {"res": RES, "steps": 200, "points": 3}

# name, the C entry points its wrapper launches, source, TPU kernel it replaces
KERNELS = (
    ("cip_velocity_phase", ("f2d_cip_velocity_phase",),
     "fluid2d_tpu_torch/csrc/cip_phases.cu", "fluid2d_tpu/ops/pallas_phases.py:490"),
    ("confinement", ("f2d_confinement",),
     "fluid2d_tpu_torch/csrc/confinement.cu", "fluid2d_tpu/ops/pallas_phases.py:1925"),
    ("sor_iteration", ("f2d_sor_iteration",),
     "fluid2d_tpu_torch/csrc/sor.cu", "fluid2d_tpu/ops/pallas_stencil.py:1238"),
    ("cip_dye_phase", ("f2d_cip_dye_phase",),
     "fluid2d_tpu_torch/csrc/cip_phases.cu", "fluid2d_tpu/ops/pallas_phases.py:1631"),
    ("mac_velocity_phase", ("f2d_mac_velocity_phase",),
     "fluid2d_tpu_torch/csrc/mac_phases.cu", "fluid2d_tpu/ops/pallas_phases.py:2094"),
    ("mac_dye_phase", ("f2d_mac_dye_phase",),
     "fluid2d_tpu_torch/csrc/mac_phases.cu", "fluid2d_tpu/ops/pallas_phases.py:2277"),
    ("jacobi_iteration", ("f2d_jacobi_iteration",),
     "fluid2d_tpu_torch/csrc/jacobi.cu", "fluid2d_tpu/ops/pallas_stencil.py:1401"),
    ("copy_add1", ("f2d_copy_add1",),
     "fluid2d_tpu_torch/csrc/probes.cu", "fluid2d_tpu/utils/profiling.py:53"),
    ("mix_twin", ("f2d_mix_twin",),
     "fluid2d_tpu_torch/csrc/probes.cu", "fluid2d_tpu/utils/profiling.py:525"),
    ("mix_twin_bf16", ("f2d_mix_twin_bf16",),
     "fluid2d_tpu_torch/csrc/probes.cu", "scripts/bf16_geometry_probe.py:108"),
    ("fma_rate", ("f2d_fma_rate",),
     "fluid2d_tpu_torch/csrc/probes.cu", "fluid2d_tpu/utils/profiling.py:702"),
    ("dtype_rate", ("f2d_dtype_rate", "f2d_dtype_rate_bf16"),
     "fluid2d_tpu_torch/csrc/dtype_probes.cu", "scripts/vpu_dtype_probe.py:101"),
    ("row_copy", ("f2d_row_copy", "f2d_row_copy_bf16"),
     "fluid2d_tpu_torch/csrc/dtype_probes.cu", "scripts/bf16_dma_probe.py:84"),
    ("cip_advect", ("f2d_cip_advect",),
     "fluid2d_tpu_torch/csrc/cip_phases.cu", "fluid2d_tpu/ops/pallas_stencil.py:948"),
    ("fma_sweep", ("f2d_fma_sweep",),
     "fluid2d_tpu_torch/csrc/probes.cu", "scripts/vpu_rate_sweep.py:49"),
    ("geometry_twin", ("f2d_geometry_twin",),
     "fluid2d_tpu_torch/csrc/probes.cu", "scripts/dma_geometry_sweep.py:232"),
    ("row_window", ("f2d_row_window",),
     "fluid2d_tpu_torch/csrc/probes.cu", "scripts/dma_rowwin_1600_check.py:57"),
    ("toy_elementwise", ("f2d_toy_elementwise",),
     "fluid2d_tpu_torch/csrc/probes.cu", "tests/test_profiling.py:134"),
    ("to_image", ("f2d_to_image",),
     "fluid2d_tpu_torch/csrc/view.cu", "none: NumPy on the host, fluid2d_tpu/utils/viz.py:139"),
)
PROBES = ("copy_add1", "mix_twin", "mix_twin_bf16", "fma_rate", "dtype_rate", "row_copy",
          "fma_sweep", "geometry_twin", "row_window", "toy_elementwise")
SWEEP_HEAD = {"chains": 8, "depth": 1024, "threads": 256}  # the fma_sweep row's timed case
TOY_SHAPES = ((32, 128), (8, 128), (2 * RES, RES))
VIEW_SHAPES = ((2 * RES, RES), (800, 400))  # V1's timed frames: the benchmark's two grids
# The port's kernels as torch.profiler names them (phase 4, profile).
PORT_KERNELS = ("cip_velocity_fused_kernel", "cip_dye_fused_kernel",
                "confinement_fused_kernel", "sor_fused_kernel", "jacobi_fused_kernel",
                "mac_velocity_fused_kernel", "mac_dye_fused_kernel",
                "cip_advect_fused_kernel")
# Device kernels of two headline steps that the profile phase counts exactly:
# one fused launch a CIP phase, SOR and confinement call (one SOR call a step,
# both iterations), none of the launches the fused SOR and confinement
# replaced, and no standalone advection.
PROFILE_COUNTS = {"cip_velocity_fused_kernel": 2, "cip_dye_fused_kernel": 2,
                  "sor_fused_kernel": 2, "confinement_fused_kernel": 2,
                  "cip_advect_fused_kernel": 0,
                  "sor_odd_kernel": 0, "sor_even_kernel": 0, "pressure_bc_kernel": 0,
                  "curl_kernel": 0, "confine_kernel": 0}
# The same for two kk steps at res=1600: one fused launch a MAC velocity and
# a MAC dye phase call, none of the two launches each replaced (the BC, the
# update); one SOR and one confinement launch a step.
KK_PROFILE_COUNTS = {"mac_velocity_fused_kernel": 2, "velocity_bc_kernel": 0,
                     "mac_velocity_update_kernel": 0, "mac_dye_fused_kernel": 2,
                     "dye_bc_kernel": 0, "mac_dye_update_kernel": 0,
                     "sor_fused_kernel": 2, "confinement_fused_kernel": 2}
# The same for two cip_jacobi2 steps: one fused launch a Jacobi call (both
# iterations), none of the two a Jacobi iteration ran before (the pressure
# BC, the sweep); the CIP phases' and confinement's one.
JACOBI_PROFILE_COUNTS = {"jacobi_fused_kernel": 2, "pressure_bc_kernel": 0,
                         "jacobi_sweep_kernel": 0, "cip_velocity_fused_kernel": 2,
                         "cip_dye_fused_kernel": 2, "confinement_fused_kernel": 2}
# Kernels held to their plain versions bit for bit at float32 too (the others
# within KERNEL_TOL, in fact 0.0): the fused ones, which are every phase
# kernel, and the standalone advection C1.
BIT_EQUAL_F32 = ("cip_velocity_phase", "cip_dye_phase", "sor_iteration", "confinement",
                 "mac_velocity_phase", "mac_dye_phase", "jacobi_iteration", "cip_advect")


def _preset_path(n: int):
    kw = dict(bench._PRESETS[n]["kw"])
    return kw.pop("bc"), kw.pop("res"), kw


# path → (scene, resolution, SimConfig.create keywords)
_F32_PATHS = {
    "cip": (SCENE, RES, {}),
    "upwind": (SCENE, RES, {"scheme": "upwind"}),
    "kk": (SCENE, RES, {"scheme": "kk"}),
    "cip_jacobi2": (SCENE, RES, {"pressure_solver": "jacobi"}),
}
PATHS = {
    **_F32_PATHS,
    "cip_jacobi6": (SCENE, RES, {"pressure_solver": "jacobi", "n_pressure_iter": 6}),
    **{f"preset{n}": _preset_path(n) for n in bench._PRESETS},
    **{f"{p}_bf16": (bc, res, {**kw, "dtype": "bfloat16"})
       for p, (bc, res, kw) in _F32_PATHS.items()},
}
RUN_PATHS = ("cip", "upwind", "kk", "cip_jacobi2", "cip_bf16")

# Kernel runs per step of each path; a kernel not named runs 0 times (the
# standalone CIP advection C1 and every probe on every path). A bf16 path runs
# what its float32 path runs.
_CIP = {"cip_velocity_phase": 1, "confinement": 1, "sor_iteration": 1, "cip_dye_phase": 1}
_MAC = {"confinement": 1, "sor_iteration": 1, "mac_velocity_phase": 1, "mac_dye_phase": 1}
_CIP_JACOBI = {"cip_velocity_phase": 1, "confinement": 1, "cip_dye_phase": 1}
RUNS_PER_STEP = {
    "cip": _CIP,
    "upwind": _MAC,
    "kk": _MAC,
    "cip_jacobi2": {**_CIP_JACOBI, "jacobi_iteration": 1},
    "cip_jacobi6": {**_CIP_JACOBI, "jacobi_iteration": 2},
    "preset1": {"mac_velocity_phase": 1, "sor_iteration": 1},
    "preset2": _MAC,
    "preset3": _CIP,
    "preset4": _CIP,
    "preset5": _CIP,
    "preset6": _CIP,
}
RUNS_PER_STEP |= {f"{p}_bf16": RUNS_PER_STEP[p] for p in _F32_PATHS}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def max_errors(got, ref, what: str, tol: float) -> tuple[float, float]:
    """(max abs error, max error / scale) over the outputs; raises if any
    output is non-finite, misshaped, or off by more than tol·max(1, |ref|max)."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} outputs, expected {len(ref)}")
    worst_abs = worst_rel = 0.0
    for k, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{what}[{k}]: {g.dtype}{tuple(g.shape)} vs {r.dtype}{tuple(r.shape)}")
        g, r = g.double(), r.double()
        if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
            raise AssertionError(f"{what}[{k}]: non-finite values")
        scale = max(1.0, float(r.abs().max()))
        err = float((g - r).abs().max())
        if err > tol * scale:
            raise AssertionError(f"{what}[{k}]: max error {err} > {tol} * {scale}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
    return worst_abs, worst_rel


def bit_errors(got, ref, what: str) -> float:
    """Raises unless every output equals its reference to the bit, dtypes
    included, a NaN equal to any NaN (the card's canonical bf16 NaN is not
    the one PyTorch's conversion gives); returns the max abs error, 0.0."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} outputs, expected {len(ref)}")
    for k, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{what}[{k}]: {g.dtype}{tuple(g.shape)} vs {r.dtype}{tuple(r.shape)}")
        gf, rf = g.float(), r.float()
        nan = torch.isnan(gf)
        if not torch.equal(nan, torch.isnan(rf)):
            raise AssertionError(f"{what}[{k}]: NaN at other cells")
        bad = int(((gf != rf) & ~nan).sum())
        if bad:
            raise AssertionError(f"{what}[{k}]: {bad} cells differ")
    return 0.0


def once_ms(fn):
    """fn's result and the device time of that one call (ms, CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take (ms): the larger of the bytes at
    the memory rate and the operations at the float32 rate, and which."""
    mem = nbytes / profiling.HBM_BYTES_PER_S * 1e3
    ops = flops / profiling.FP32_FLOPS_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def kernel_cases(scene, cfg, dev, dtype=torch.float32):
    """Per kernel: a list of (variant, wrapper call, plain call) on seeded
    random inputs at the main path's shapes, with state and scene in
    `dtype`; at bf16 also every pressure chain link. The first variant is
    the one the paths run most; its times head the kernel table."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    shape = scene.shape

    def rnd(lead, scale, offset=0.0):
        return (scale * torch.randn((*lead, *shape), generator=gen, device=dev) + offset).to(dtype)

    p, pa = rnd((), 0.3), rnd((), 0.3)
    u, w = rnd((), 8.0), rnd((), 8.0)  # |v| straddles the limit of 10
    v, va = rnd((2,), 0.5), rnd((2,), 0.5)
    vg = [rnd((2,), 0.1) for _ in range(4)]
    dye, da = rnd((3,), 0.5, 0.5), rnd((3,), 0.5, 0.5)
    dg = [rnd((3,), 0.1) for _ in range(4)]
    conf = (v, va, scene.fluid8, cfg.dt, cfg.vor_eps, cfg.dx)
    vel = (v, p, va, *vg, scene, cfg.re, cfg.dt, cfg.dx)
    dyes = (dye, da, *dg, v, scene, cfg.re, cfg.dt, cfg.dx)
    lim = cfg.velocity_limit

    def pair(wrapper, plain, args, **kw):
        return (lambda: wrapper(*args, **kw)), (lambda: plain(*args, **kw))

    def mac_vel(scheme):
        return (v, p, va, scene, scheme, cfg.re, cfg.dt, cfg.dx)

    def mac_dye(scheme):
        return (dye, da, v, scene, scheme, cfg.dt, cfg.dx)

    # C1: the dye form (3 channels by the velocity) and the velocity form
    # (vel is f: v passed twice, the same tensor)
    adv_dye = (dye, dg[0], dg[1], v, da, dg[2], dg[3], scene.fluid8, cfg.dt, cfg.dx)
    adv_vel = (v, vg[0], vg[1], v, va, vg[2], vg[3], scene.fluid8, cfg.dt, cfg.dx)

    # pressure links: (ledger suffix, p, p_alt, out_dtype); at bf16 every
    # link of a chain
    if dtype == torch.float32:
        links = [("", p, pa, None)]
    else:
        p32, pa32 = p.float(), pa.float()
        links = [("", p, pa, BF16), ("_f32out", p, pa, torch.float32),
                 ("_f32in", p32, pa32, BF16), ("_f32in_f32out", p32, pa32, torch.float32)]
    sor, jacobi = [], []
    for link, pc, pal, out in links:
        sargs = (pc, pal, u, w, scene.pbc_code, scene.fluid8, cfg.sor_omega, cfg.dt, cfg.dx)
        jargs = (pc, pal, u, w, scene.pbc_code, scene.not_wall8, cfg.dt, cfg.dx)
        for n, vl in ((2, lim), (2, None), (1, None), (1, lim)):
            sor.append((("" if n == 1 else f"_n{n}") + link + ("_v_limit" if vl else ""),
                        *pair(cuda_stencil.sor_iteration_cuda, cuda_stencil.sor_iteration_plain,
                              sargs, n_iters=n, v_limit=vl, out_dtype=out)))
        for n, vl in ((2, lim), (1, None), (1, lim), (2, None), (4, None), (4, lim), (3, lim)):
            jacobi.append((f"_n{n}{link}" + ("_v_limit" if vl else ""),
                           *pair(cuda_stencil.jacobi_iteration_cuda,
                                 cuda_stencil.jacobi_iteration_plain, jargs, n_iters=n,
                                 v_limit=vl, out_dtype=out)))
    # the paths' calls first: one SOR call of two iterations, one Jacobi call
    # of two, each with the limiter
    sor.sort(key=lambda case: case[0] != "_n2_v_limit")
    jacobi.sort(key=lambda case: case[0] != "_n2_v_limit")
    return {
        "cip_velocity_phase": [("", *pair(cuda_phases.cip_velocity_phase_cuda,
                                          cuda_phases.cip_velocity_phase_plain, vel))],
        "confinement": [("", *pair(cuda_phases.confinement_cuda,
                                   cuda_phases.confinement_plain, conf))],
        "sor_iteration": sor,
        "cip_dye_phase": [("", *pair(cuda_phases.cip_dye_phase_cuda,
                                     cuda_phases.cip_dye_phase_plain, dyes))],
        "mac_velocity_phase": [
            (f"_{scheme}", *pair(cuda_phases.mac_velocity_phase_cuda,
                                 cuda_phases.mac_velocity_phase_plain, mac_vel(scheme)))
            for scheme in ("upwind", "kk")
        ],
        "mac_dye_phase": [
            (f"_{scheme}", *pair(cuda_phases.mac_dye_phase_cuda,
                                 cuda_phases.mac_dye_phase_plain, mac_dye(scheme)))
            for scheme in ("upwind", "kk")
        ],
        "jacobi_iteration": jacobi,
        "cip_advect": [
            (variant, *pair(cuda_stencil.cip_advect_cuda, cuda_stencil.cip_advect_plain, args))
            for variant, args in (("", adv_dye), ("_self", adv_vel))
        ],
    }


def seeded_state(scene, cfg, dev):
    """The smooth seeded state of __graft_entry__.py (fluid cells only), in
    the config's transport dtype."""
    st = init_state(scene, cfg, dev)
    dt = getattr(torch, cfg.dtype)
    x_rows, y_cols = scene.shape
    fluid = (scene.mask.cpu().numpy() == 0).astype(np.float32)
    gx = np.linspace(0, 2 * np.pi, x_rows, dtype=np.float32)[:, None]
    gy = np.linspace(0, 2 * np.pi, y_cols, dtype=np.float32)[None, :]
    u = 0.3 * np.sin(gx) * np.cos(2 * gy) * fluid
    w = 0.2 * np.cos(2 * gx) * np.sin(gy) * fluid
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev).to(dt)  # noqa: E731
    st = st._replace(v=as_t(np.stack([u, w])), p=as_t(0.1 * np.sin(gx + gy) * fluid))
    if cfg.enable_dye:
        dye = np.stack([0.5 + 0.4 * np.sin(k * gx) * np.cos(gy) * fluid for k in (1, 2, 3)])
        st = st._replace(dye=as_t(dye))
    return st


def reset_counts() -> None:
    launch_counter.clear()


def read_counts() -> dict[str, int]:
    """Kernel runs by KERNELS row since the last reset (the launch counter
    by C entry point, ``fluid2d_tpu_torch/utils/trace.py``)."""
    runs = entry_launches()
    return {name: sum(runs[e] for e in entries) for name, entries, *_ in KERNELS}


def check_counts(counts: dict[str, int], path: str, steps: int, what: str,
                 frames: int = 0) -> None:
    """The kernel runs of `steps` steps of `path`, and one image kernel run
    a frame written."""
    per_step = RUNS_PER_STEP[path]
    want = {name: per_step.get(name, 0) * steps for name, *_ in KERNELS}
    want["to_image"] = frames
    if counts != want:
        raise AssertionError(f"{what}: kernel runs {counts}, expected {want}")


def leaves(state):
    return [(name, leaf) for name, leaf in zip(state._fields, state) if leaf is not None]


def _cfg_scene(path, dev, **over):
    bc, res, kw = PATHS[path]
    cfg = SimConfig.create(resolution=res, **{**kw, **over})
    return cfg, scene_for_dtype(get_scene(bc, res, dev), cfg)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    phase_s = {}

    def lap(name: str) -> None:
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib_path.name})
    lap("1-2 device, build")

    # 3. kernels against their plain versions at the main path's shapes, and
    # the byte ledger of each against its registered operand mix
    table = {}
    for dtype in (torch.float32, BF16):
        cfg = SimConfig.create(resolution=RES, dtype=str(dtype).removeprefix("torch."))
        scene = scene_for_dtype(get_scene(SCENE, RES, dev), cfg)
        check_kernels(kernel_cases(scene, cfg, dev, dtype), scene, dtype, table)

    # 3b. the roofline's probes and the bf16 probes against their plain versions
    check_probes(get_scene(SCENE, RES, dev).shape, dev, table)
    lap("3 kernels, probes")

    # 4. parity of every path: kernels against the eager path, 4 steps; the
    # profiler's kernel list of a headline step at both dtypes
    for path in PATHS:
        check_parity(path, dev)
    check_profile(dev)
    lap("4 parity, profile")

    # 5. the paths through the user's entry point
    launches = {}
    for path in RUN_PATHS:
        launches[path] = run_path(path, dev)
    lap("5 run")

    # 6. the bench entry points: the headline and presets 1-6, both dtypes
    headlines = {}
    for dtype in ("float32", "bfloat16"):
        launches[f"bench_{dtype}"] = run_bench(dev, dtype, headlines)
    lap("6 bench")

    # 7. the roofline report (bench --roofline)
    for scheme, dtype in (("cip", "float32"), ("kk", "float32"), ("cip", "bfloat16")):
        launches[f"roofline_{scheme}_{dtype}"] = run_roofline(scheme, dtype, dev)
    lap("7 roofline")

    # 8. the bf16 probe scripts through their entry points
    launches["bf16_probes"] = run_bf16_probes(dev)
    lap("8 bf16 probes")

    # 9. C1 at the op level and the last probe scripts through their entry points
    launches["last_probes"] = run_last_probes(dev, table)
    lap("9 last probes")

    # 10. the front end: the CLI (run, resume, frames, logs, checkpoints), the
    # card's views, the study scripts
    launches |= run_front_end(headlines)
    lap("10 front end")

    names = [name for name, *_ in KERNELS]
    totals = {name: sum(counts.get(name, 0) for counts in launches.values()) for name in names}
    missing = [name for name, n in totals.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched by a driven path: {missing}")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start, "phase_seconds": phase_s})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": totals[name],
         "launches_by_path": {path: counts.get(name, 0) for path, counts in launches.items()},
         **table[name]}
        for name, _, source, replaces in KERNELS
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


def _row(table, name, variant, err, ms, plain_ms, bound_ms, bound_by, library_ms=None,
         suffix=""):
    """Fold one variant into the kernel table: the first variant at float32
    heads the row (ms, plain_ms, bound_ms, bound_by, library_ms), the first
    at bf16 fills the *_bf16 keys; max_abs_err is the worst of all."""
    row = table.setdefault(name, {"max_abs_err": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                     ("bound_by", bound_by), ("library_ms", library_ms)):
        row.setdefault(key + suffix, val)
    if variant:
        row[f"ms{variant}{suffix}"] = ms


def check_kernels(cases, scene, dtype, table) -> None:
    """Phase 3 at one dtype: each variant against its plain version (within
    KERNEL_TOL at float32, to the bit at bf16), its ledger against its mix,
    the first variant of each kernel timed with its bound."""
    itemsize = dtype.itemsize
    suffix = "" if dtype == torch.float32 else "_bf16"
    for name, variants in cases.items():
        for k, (variant, kernel, plain) in enumerate(variants):
            launch.TRAFFIC_LOG = ledger = []
            try:
                got = kernel()
            finally:
                launch.TRAFFIC_LOG = None
            torch.cuda.synchronize()
            ref = plain()
            if dtype == torch.float32 and name not in BIT_EQUAL_F32:
                err, rel = max_errors(got, ref, name + variant, KERNEL_TOL)
                tol = KERNEL_TOL
            else:
                err = rel = bit_errors(got, ref, name + variant + suffix)
                tol = 0.0
            want = [(name + variant, profiling.mix_bytes(name + variant, *scene.shape, itemsize))]
            if ledger != want:
                raise AssertionError(f"registry[{name + variant}{suffix}]: ledger {ledger}, "
                                     f"mix {want}")
            # at bf16 the first variant of each kernel, and both forms of C1
            timed = k == 0 or dtype == torch.float32 or name == "cip_advect"
            ms = median_ms(kernel) if timed else None
            plain_ms = median_ms(plain) if timed else None
            flops, _ = profiling.collect_elops(plain)
            needed = profiling.needed_bytes(name + variant, scene, itemsize)
            bound_ms, bound_by = bound(needed, flops)
            ledger_bound_ms, _ = bound(ledger[0][1], flops)
            emit({"phase": "kernel", "name": name + variant, "dtype": str(dtype), "max_abs_err": err,
                  "max_rel_err": rel, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by, "ledger_bound_ms": ledger_bound_ms,
                  "grid": list(scene.shape), "needed_bytes": needed, "ledger_bytes": ledger[0][1]})
            if timed:
                _row(table, name, variant, err, ms, plain_ms, bound_ms, bound_by, suffix=suffix)
                table[name].setdefault("ledger_bound_ms" + suffix, ledger_bound_ms)
            else:
                table[name]["max_abs_err"] = max(table[name]["max_abs_err"], err)


def check_probes(shape, dev, table) -> None:
    """Phase 3b: C2, C3 at float32 and bf16 (C5c), C4, C5a and C5b against
    their plain versions, each timed with its bound."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    # C2: the copy on measure_hbm_bandwidth's working set, beside torch.add
    rows = max(64, (320 * 2**20 // 2 // 4 // 2048) // 64 * 64)
    x = torch.randn((rows, 2048), generator=gen, device=dev)
    out = torch.empty_like(x)
    got = cuda_probes.copy_add1_cuda(x, out=out)
    torch.cuda.synchronize()
    err, _ = max_errors((got,), (cuda_probes.copy_add1_plain(x),), "copy_add1", 0.0)
    ms = median_ms(lambda: cuda_probes.copy_add1_cuda(x, out=out))
    plain_ms = median_ms(lambda: cuda_probes.copy_add1_plain(x))
    library_ms = median_ms(lambda: torch.add(x, 1, out=out))
    b = bound(2 * x.numel() * 4, x.numel())
    emit({"phase": "probe", "name": "copy_add1", "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b[0], "shape": [rows, 2048]})
    _row(table, "copy_add1", "", err, ms, plain_ms, *b, library_ms=library_ms)

    # C3: the twin of every registered mix at float32 (the chain links are
    # float32 planes there, the same as the plain mixes) and at bf16 (C5c)
    for dtype in (torch.float32, BF16):
        itemsize = dtype.itemsize
        name = "mix_twin" if dtype == torch.float32 else "mix_twin_bf16"
        for mix in profiling._KERNEL_MIXES:
            if dtype == torch.float32 and "_f32" in mix:
                continue
            ops = profiling.twin_operands(mix, *shape, dev, dtype)
            got = cuda_probes.mix_twin_cuda(ops)
            torch.cuda.synchronize()
            ref = cuda_probes.mix_twin_plain(ops)
            if dtype == torch.float32:
                err, _ = max_errors(got, ref, f"mix_twin_{mix}", KERNEL_TOL)
            else:
                err = bit_errors(got, ref, f"mix_twin_bf16_{mix}")
            ms = median_ms(lambda ops=ops: cuda_probes.mix_twin_cuda(ops))
            plain_ms = median_ms(lambda ops=ops: cuda_probes.mix_twin_plain(ops), 5)
            nbytes = profiling.mix_bytes(mix, *shape, itemsize)
            b = bound(nbytes, (len(ops.f32_in) + len(ops.bf16_in) + len(ops.i8_in))
                      * shape[0] * shape[1])
            emit({"phase": "probe", "name": f"{name}_{mix}", "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": b[0], "GBps": nbytes / ms / 1e6})
            _row(table, name, f"_{mix}", err, ms, plain_ms, *b)
            del ops

    # C4: the FMA chains, shallow against the plain version, deep timed
    fx = torch.rand((2048, 1024), generator=gen, device=dev)
    got = cuda_probes.fma_rate_cuda(fx, FMA_CHECK_PASSES)
    torch.cuda.synchronize()
    err, _ = max_errors((got,), (cuda_probes.fma_rate_plain(fx, FMA_CHECK_PASSES),), "fma_rate",
                        KERNEL_TOL)
    ms = median_ms(lambda: cuda_probes.fma_rate_cuda(fx, FMA_PASSES))
    plain_ms = median_ms(lambda: cuda_probes.fma_rate_plain(fx, FMA_PASSES), PLAIN_FMA_CALLS)
    b = bound(2 * fx.numel() * 4, 2 * fx.numel() * FMA_PASSES)
    emit({"phase": "probe", "name": "fma_rate", "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": b[0], "passes": FMA_PASSES})
    _row(table, "fma_rate", "", err, ms, plain_ms, *b)
    table["fma_rate"].update(check_fma_depth(dev))

    # C5a: the dtype-rate chains on the timed (2048, 1024) inputs: each mode
    # and dtype at the check depth against the plain version (a step more or
    # fewer must miss it at every element); the fma mode, which the row times
    # and bounds, also at the timed depth RATE_PASSES, where the plain
    # version's one run is timed too
    xr = 2.0 + torch.rand((2048, 1024), generator=gen, device=dev)
    check = {}
    for dtype in (torch.float32, BF16):
        xd = xr.to(dtype)
        dname = str(dtype).removeprefix("torch.")
        for mode in cuda_dtype_probes.RATE_MODES:
            check[f"{mode}_{dname}"] = vpu_dtype_probe.check_dtype_rate(mode, dtype, dev, x=xd)
        got = cuda_dtype_probes.dtype_rate_cuda(xd, RATE_PASSES, "fma")
        ref, plain_ms = once_ms(lambda xd=xd: cuda_dtype_probes.dtype_rate_plain(
            xd, RATE_PASSES, "fma"))
        deep = float(cuda_dtype_probes.ulps_apart(got, ref).max())
        tol = cuda_dtype_probes.RATE_TOL_ULPS[dtype]
        if not (deep <= tol and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"dtype_rate[fma, {dname}] at {RATE_PASSES} passes: {deep} ulps "
                                 f"from the plain version (tolerance {tol})")
        check[f"fma_{dname}"]["max_err_ulps_deep"] = deep
        err = float((got.double() - ref.double()).abs().max())
        ms = median_ms(lambda xd=xd: cuda_dtype_probes.dtype_rate_cuda(xd, RATE_PASSES, "fma"))
        # FFMA: 2 flops an element a pass; HFMA2 the same per bf16 element
        # at twice the float32 lanes an instruction (half the float32 time).
        lanes = 1 if dtype == torch.float32 else 2
        b = bound(2 * xd.numel() * xd.element_size(), 2 * xd.numel() * RATE_PASSES / lanes)
        _row(table, "dtype_rate", "", err, ms, plain_ms, *b,
             suffix="" if dtype == torch.float32 else "_bf16")
    emit({"phase": "probe_check", "name": "dtype_rate",
          "passes": [cuda_dtype_probes.RATE_CHECK_PASSES, RATE_PASSES], "checks": check})
    table["dtype_rate"] |= {"mode": "fma", "passes": RATE_PASSES, "shape": [2048, 1024]}

    # C5b: the three row-window copies, both dtypes, bit-equal
    for dtype in (torch.float32, BF16):
        xc = (torch.arange(256 * 256, dtype=torch.float32, device=dev).reshape(256, 256)
              * 1e-4).to(dtype)
        for mode in cuda_dtype_probes.COPY_MODES:
            got = cuda_dtype_probes.row_copy_cuda(xc, mode)
            torch.cuda.synchronize()
            err = bit_errors((got,), (cuda_dtype_probes.row_copy_plain(xc, mode),),
                             f"row_copy_{mode}_{dtype}")
            if mode == "tail":
                ms = median_ms(lambda xc=xc: cuda_dtype_probes.row_copy_cuda(xc, "tail"))
                plain_ms = median_ms(lambda xc=xc: cuda_dtype_probes.row_copy_plain(xc, "tail"))
                oc = torch.empty((16, 256), device=dev)
                library_ms = median_ms(lambda xc=xc, oc=oc: oc.copy_(xc[8:24]))
                b = bound(16 * 256 * (xc.element_size() + 4), 0)
                _row(table, "row_copy", "", err, ms, plain_ms, *b, library_ms=library_ms,
                     suffix="" if dtype == torch.float32 else "_bf16")
    emit({"phase": "probe", "name": "row_copy", "bit_equal": True, **table["row_copy"]})


def check_fma_depth(dev) -> dict:
    """C4's checks beyond the shallow comparison of check_probes, at the
    probe's shape: the timed depth (FMA_PASSES) within the rounding bound
    of the float64 plain version, and two negative controls, which show
    that the checks see a missing round: the plain version one round short
    must fail KERNEL_TOL at the shallow depth and the bound at every element
    at full depth. Returns the errors and margins."""
    gen = torch.Generator(device=dev).manual_seed(4322)
    fx = torch.rand((2048, 1024), generator=gen, device=dev)
    short = FMA_CHECK_PASSES - cuda_probes.FMA_CHAINS
    got = cuda_probes.fma_rate_cuda(fx, FMA_CHECK_PASSES)
    miss = cuda_probes.fma_rate_plain(fx, short)
    shallow_miss = float((got - miss).abs().max())
    shallow_tol = KERNEL_TOL * max(1.0, float(miss.abs().max()))
    if shallow_miss <= shallow_tol:
        raise AssertionError(f"fma_rate: {short} passes within {shallow_tol} of "
                             f"{FMA_CHECK_PASSES} ({shallow_miss}): the check cannot see a round")
    deep = cuda_probes.fma_rate_cuda(fx, FMA_PASSES).double()
    bound_ = cuda_probes.fma_rate_error_bound(fx, FMA_PASSES)
    exact = cuda_probes.fma_rate_plain(fx.double(), FMA_PASSES)
    deep_err = float((deep - exact).abs().max())
    if deep_err > bound_:
        raise AssertionError(f"fma_rate at {FMA_PASSES} passes: error {deep_err} > bound {bound_}")
    short64 = cuda_probes.fma_rate_plain(fx.double(), FMA_PASSES - cuda_probes.FMA_CHAINS)
    deep_miss = float((deep - short64).abs().min())
    if deep_miss <= bound_:
        raise AssertionError(f"fma_rate: one round short is within the bound {bound_} "
                             f"({deep_miss}) at some element")
    out = {"max_abs_err_full_depth": deep_err, "bound_full_depth": bound_,
           "one_round_short_min_err_full_depth": deep_miss,
           "one_round_short_max_err_shallow": shallow_miss, "tol_shallow": shallow_tol}
    emit({"phase": "probe_check", "name": "fma_rate", "passes": [FMA_CHECK_PASSES, FMA_PASSES],
          **out})
    return out


def run_bench(dev, dtype: str, headlines: dict[str, float]) -> dict[str, int]:
    """bench_config for the headline and run_preset for presets 1-6 at
    `dtype`; each run must be stable and move the counters by its runs per
    step times its 2n steps (warm-up and timed). Records the headline's
    steps/s in `headlines[dtype]`; returns the summed counts."""
    sfx = "" if dtype == "float32" else "_bf16"

    def headline():
        rate, state = bench.bench_config(RES, "cip", HEADLINE_STEPS, dtype=dtype, device=dev)
        headlines[dtype] = rate
        return {"metric": f"steps_per_sec_res{RES}_cip" + ("" if not sfx else f"_{dtype}"),
                "value": rate, "unit": "steps/s", "dtype": str(state.v.dtype),
                "stable": bool(torch.isfinite(state.v.float()).all())}

    runs = [("cip", 2 * HEADLINE_STEPS, headline)]
    runs += [(f"preset{n}", 2 * p["steps"], lambda n=n: bench.run_preset(n, dtype, device=dev))
             for n, p in bench._PRESETS.items()]
    total = dict.fromkeys(read_counts(), 0)
    for path, steps, fn in runs:
        reset_counts()
        row = fn()
        counts = read_counts()
        check_counts(counts, path, steps, f"bench[{path}{sfx}]")
        if not row["stable"]:
            raise AssertionError(f"bench[{path}{sfx}]: not stable: {row}")
        emit({"phase": "bench", "path": path + sfx, "steps": steps, **row, "launches": counts})
        for name, n in counts.items():
            total[name] += n
    return total


def run_roofline(scheme: str, dtype: str, dev) -> dict[str, int]:
    """roofline_report for `scheme` at res=1600 and `dtype` with the counters
    at 0: the simulation kernels run 2·ROOFLINE_STEPS + 1 steps' worth
    (timing and the byte ledger), and each roofline probe launches at least
    once. At bf16 the twins of the bf16 variants are the bf16 twin (C5c)."""
    reset_counts()
    rep = profiling.roofline_report(RES, scheme, ROOFLINE_STEPS, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    emit({"phase": "roofline", "scheme": scheme, "dtype": dtype, "res": RES, "roofline": rep,
          "launches": counts})
    per_step = RUNS_PER_STEP[scheme]
    want = {name: per_step.get(name, 0) * (2 * ROOFLINE_STEPS + 1)
            for name, *_ in KERNELS if name not in PROBES}
    got = {name: n for name, n in counts.items() if name not in PROBES}
    twin = "mix_twin" if dtype == "float32" else "mix_twin_bf16"
    roofline_probes = ("copy_add1", twin, "fma_rate")
    if got != want or not all(counts[name] > 0 for name in roofline_probes):
        raise AssertionError(f"roofline[{scheme}, {dtype}]: kernel runs {counts}, expected {want} "
                             f"and every roofline probe > 0")
    if not 0.0 < rep["streaming_copy_GBps"] <= PUBLISHED_GBPS:
        raise AssertionError(f"roofline[{scheme}]: copy bandwidth {rep['streaming_copy_GBps']} "
                             f"GB/s outside (0, {PUBLISHED_GBPS}]")
    for name, row in rep["kernels"].items():
        if not (row.get("ceiling_GBps", 0) > 0 and row.get("floor_ms", 0) > 0):
            raise AssertionError(f"roofline[{scheme}]: kernel {name} lacks a ceiling or floor")
    if not (rep["kernels"] and 0.0 < rep.get("pct_of_geometry_roofline", 0.0) <= 100.0):
        raise AssertionError(f"roofline[{scheme}, {dtype}]: geometry roofline share "
                             f"{rep.get('pct_of_geometry_roofline')} outside (0, 100]")
    return counts


def run_bf16_probes(dev) -> dict[str, int]:
    """Phase 8: the three bf16 probe scripts through their entry points,
    with the counters at 0; a failed check or copy raises."""
    reset_counts()
    for mode in cuda_dtype_probes.RATE_MODES:
        res = vpu_dtype_probe.measure_dtype_rate(mode, RATE_PASSES, device=dev)
        if mode == "fma":  # the mode the kernel table bounds: 2 flops a pass
            n = 2048 * 1024
            res["bound_ms"] = {"float32": bound(0, 2 * n * RATE_PASSES)[0],
                               "bfloat16": bound(0, n * RATE_PASSES)[0]}
            res["share_of_bound"] = {k: b / res["ms"][k] for k, b in res["bound_ms"].items()}
        emit({"phase": "bf16_probe", "probe": "vpu_dtype_probe", **res})
    for dtype in (torch.float32, BF16):
        ok = bf16_dma_probe.probe(dtype, dev)
        emit({"phase": "bf16_probe", "probe": "bf16_dma_probe", **ok})
        if not all(ok.values()):
            raise AssertionError(f"bf16_dma_probe: FAIL {ok}")
    for name in bf16_geometry_probe.CASES:
        for row in bf16_geometry_probe.geometry_rows(name, RES, dev):
            emit({"phase": "bf16_probe", "probe": "bf16_geometry_probe", **row})
    torch.cuda.synchronize()
    counts = read_counts()
    emit({"phase": "bf16_probe", "launches": counts})
    return counts


def _advect_calls(dev) -> dict[str, tuple]:
    """C1's op-level calls at the main path's grid: the dye form and the
    velocity form (vel is f), float32 and bf16, on seeded fields."""
    scene = get_scene(SCENE, RES, dev)
    cfg = SimConfig.create(resolution=RES)
    gen = torch.Generator(device=dev).manual_seed(2468)
    calls = {}
    for dtype in (torch.float32, BF16):
        def rnd(lead, scale, dtype=dtype):
            t = scale * torch.randn((lead, *scene.shape), generator=gen, device=dev)
            return t.to(dtype)

        v = rnd(2, 8.0)
        d, v_alt = rnd(3, 0.5), rnd(2, 0.5)
        sfx = "" if dtype == torch.float32 else "_bf16"
        calls["dye" + sfx] = (d, rnd(3, 0.1), rnd(3, 0.1), v, rnd(3, 0.5), rnd(3, 0.1),
                              rnd(3, 0.1), scene.fluid8, cfg.dt, cfg.dx)
        calls["velocity" + sfx] = (v, rnd(2, 0.1), rnd(2, 0.1), v, v_alt, rnd(2, 0.1),
                                   rnd(2, 0.1), scene.fluid8, cfg.dt, cfg.dx)
    return calls


def run_last_probes(dev, table) -> dict[str, int]:
    """Phase 9: C1 at the op level and the last probe scripts (C5d–g) and
    toys (C6) through their entry points, with the counters at 0; then, the
    counts read, each new kernel held to its plain version on the inputs it
    times and timed into the kernel table. A failed check raises."""
    reset_counts()
    advect = _advect_calls(dev)
    for form, args in advect.items():
        outs = cuda_stencil.cip_advect_cuda(*args)
        if not all(o.shape == args[0].shape and o.dtype == args[0].dtype
                   and bool(torch.isfinite(o.float()).all()) for o in outs):
            raise AssertionError(f"cip_advect[{form}]: outputs not finite or misshaped")
    swept = vpu_rate_sweep.sweep(device=dev)
    emit({"phase": "last_probe", "probe": "vpu_rate_sweep", "best": swept["best"],
          "checks": swept["checks"],
          "cases": {c["tag"]: c["Gelops"] for c in swept["cases"]}})
    geo = dma_geometry_sweep.main(["--only", "incount,triples,outs,bigcopy"])
    emit({"phase": "last_probe", "probe": "dma_geometry_sweep", **geo})
    geo_bench = dma_geometry_bench.bench(RES, device=dev)
    emit({"phase": "last_probe", "probe": "dma_geometry_bench", **geo_bench})
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        dma_rowwin_1600_check.main(["1600"])
    print(text.getvalue(), end="", flush=True)
    if "values OK" not in text.getvalue():
        raise AssertionError(f"dma_rowwin_1600_check 1600: {text.getvalue()!r}")
    gen = torch.Generator(device=dev).manual_seed(1357)
    toys = {shape: torch.randn(shape, generator=gen, device=dev) for shape in TOY_SHAPES}
    for x in toys.values():
        for op in cuda_probes.TOY_OPS:
            cuda_probes.toy_elementwise_cuda(x, op)
    torch.cuda.synchronize()
    counts = read_counts()
    emit({"phase": "last_probe", "launches": counts})

    check_advect(advect, dev, table)
    check_fma_sweep(dev, swept, table)
    check_geometry_twin(dev, table)
    check_row_window(dev, table)
    check_toys(toys, table)
    check_view(dev, table)
    return counts


def check_advect(calls, dev, table) -> None:
    """C1's op-level calls of phase 9 on the inputs they ran: bit-equal to
    the plain version, and each timed (median_ms) beside its bound, the
    bytes its form needs on the scene and the plain version's el-ops."""
    scene = get_scene(SCENE, RES, dev)
    row = table["cip_advect"].setdefault("op_level_ms", {})
    for form, args in calls.items():
        got = cuda_stencil.cip_advect_cuda(*args)
        torch.cuda.synchronize()
        bit_errors(got, cuda_stencil.cip_advect_plain(*args), f"cip_advect[{form}]")
        ms = median_ms(lambda args=args: cuda_stencil.cip_advect_cuda(*args))
        flops, _ = profiling.collect_elops(lambda args=args: cuda_stencil.cip_advect_plain(*args))
        mix = "cip_advect_self" if args[3] is args[0] else "cip_advect"
        bound_ms, bound_by = bound(profiling.needed_bytes(mix, scene, args[0].element_size()),
                                   flops)
        row[form] = ms
        emit({"phase": "last_probe_check", "name": f"cip_advect_{form}", "bit_equal": True,
              "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "share_of_bound": bound_ms / ms})


def check_fma_sweep(dev, swept, table) -> None:
    """The sweep's timed 8-chain case at full depth on its timed inputs
    (the sweep checked every chain count and depth before timing): within
    fma_rate_error_bound, one round short beyond it; timed with its plain
    version."""
    n, d, threads = SWEEP_HEAD["chains"], SWEEP_HEAD["depth"], SWEEP_HEAD["threads"]
    x = vpu_rate_sweep.sweep_inputs(2048, 1024, dev)
    res = vpu_rate_sweep.check_chains(x, n, d, threads)
    ms = median_ms(lambda: cuda_probes.fma_sweep_cuda(x, d, n, threads))
    plain_ms = median_ms(lambda: cuda_probes.fma_rate_plain(x, d, n), PLAIN_FMA_CALLS)
    b = bound(2 * x.numel() * 4, 2 * x.numel() * d)
    err = max(c["max_abs_err"] for c in swept["checks"].values())
    _row(table, "fma_sweep", "", err, ms, plain_ms, *b)
    table["fma_sweep"] |= {"case": SWEEP_HEAD, "check": res, "best": swept["best"]}
    emit({"phase": "last_probe_check", "name": "fma_sweep", **SWEEP_HEAD, **res, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": b[0]})


def check_geometry_twin(dev, table) -> None:
    """dma_geometry_bench's four geometries at the main path's grid (h = 1,
    0 and 8 with 3 channels on z; the packed one, h = 8) within KERNEL_TOL of
    the plain version; the h = 1 dye mix heads the row."""
    for name in dma_geometry_bench.GEOMETRIES:
        ops = dma_geometry_bench.geometry(name, RES, dev)
        got = cuda_probes.geometry_twin_cuda(ops)
        torch.cuda.synchronize()
        ref = cuda_probes.geometry_twin_plain(ops)
        err, _ = max_errors(got, ref, f"geometry_twin[{name}]", KERNEL_TOL)
        ms = median_ms(lambda ops=ops: cuda_probes.geometry_twin_cuda(ops))
        plain_ms = median_ms(lambda ops=ops: cuda_probes.geometry_twin_plain(ops), 5)
        flops, _ = profiling.collect_elops(cuda_probes.geometry_twin_plain, ops)
        b = bound(ops.nbytes, flops)
        _row(table, "geometry_twin", f"_{name}", err, ms, plain_ms, *b)
        emit({"phase": "last_probe_check", "name": f"geometry_twin_{name}", "h": ops.h,
              "channels": ops.channels, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b[0], "GBps": ops.nbytes / ms / 1e6})
        del ops, got, ref


def check_row_window(dev, table) -> None:
    """C5g at Y=1600 on seeded normal values: bit-equal to 2·a and to the
    plain windows; timed beside torch.mul(a, 2.0, out=o)."""
    t = cuda_probes.row_window_tile(2 * RES, RES)
    a = torch.randn((2 * RES, RES), generator=torch.Generator(device=dev).manual_seed(97),
                    device=dev)
    got = cuda_probes.row_window_cuda(a, t)
    torch.cuda.synchronize()
    err = bit_errors((got, got), (2.0 * a, cuda_probes.row_window_plain(a, t)), "row_window")
    ms = median_ms(lambda: cuda_probes.row_window_cuda(a, t))
    plain_ms = median_ms(lambda: cuda_probes.row_window_plain(a, t))
    o = torch.empty_like(a)
    library_ms = median_ms(lambda: torch.mul(a, 2.0, out=o))
    b = bound(2 * a.numel() * 4, a.numel())
    _row(table, "row_window", "", err, ms, plain_ms, *b, library_ms=library_ms)
    table["row_window"] |= {"t": t, "h": 8, "window_bytes": (t + 16) * RES * 4,
                            "ring_slots": cuda_probes.row_window_slots(RES)}
    emit({"phase": "last_probe_check", "name": "row_window", "t": t, "bit_equal": True, "ms": ms,
          "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b[0]})


def check_toys(toys, table) -> None:
    """C6: every toy bit-equal to its plain version at every shape and on a
    view at offset 1 of the largest (not 16-byte aligned: the kernel's
    scalar path); the el-op counter on the plain versions
    (tests/test_profiling.py:143, :168); the division toy at 3200×1600 heads
    the row beside torch.div, the x·3 toy beside torch.mul."""
    big = toys[(2 * RES, RES)]
    shifted = big.flatten()[1:1 + (2 * RES - 1) * RES].view(2 * RES - 1, RES)
    for shape, x in [*toys.items(), ("offset 1", shifted)]:
        for op in cuda_probes.TOY_OPS:
            bit_errors((cuda_probes.toy_elementwise_cuda(x, op),),
                       (cuda_probes.toy_elementwise_plain(x, op),), f"toy_{op}[{shape}]")
    small, tiny = toys[(32, 128)], toys[(8, 128)]
    elops = {"mul2add1_32x128": profiling.collect_elops(cuda_probes.toy_elementwise_plain, small,
                                                        "mul2add1")[0],
             **{f"{op}_8x128": profiling.collect_elops(cuda_probes.toy_elementwise_plain, tiny,
                                                       op)[0] for op in ("div3", "mul3")}}
    if (elops["mul2add1_32x128"] != 2 * 8 * 128 * 4
            or not elops["div3_8x128"] > elops["mul3_8x128"]):
        raise AssertionError(f"el-op counter on the toys: {elops}")
    x = toys[(2 * RES, RES)]
    o = torch.empty_like(x)
    library = {"div3": lambda: torch.div(x, 3.0, out=o),
               "mul3": lambda: torch.mul(x, 3.0, out=o), "mul2add1": None}
    for op in ("div3", "mul3", "mul2add1"):
        ms = median_ms(lambda op=op: cuda_probes.toy_elementwise_cuda(x, op))
        plain_ms = median_ms(lambda op=op: cuda_probes.toy_elementwise_plain(x, op))
        library_ms = median_ms(library[op]) if library[op] else None
        flops, _ = profiling.collect_elops(cuda_probes.toy_elementwise_plain, x, op)
        b = bound(2 * x.numel() * 4, flops)
        _row(table, "toy_elementwise", f"_{op}", 0.0, ms, plain_ms, *b, library_ms=library_ms)
        if library_ms is not None:
            table["toy_elementwise"][f"library_ms_{op}"] = library_ms
    table["toy_elementwise"] |= {"op": "div3", "shape": [2 * RES, RES], "elops": elops}
    emit({"phase": "last_probe_check", "name": "toy_elementwise", "bit_equal": True,
          "elops": elops, **table["toy_elementwise"]})


def check_parity(path: str, dev) -> None:
    """PARITY_STEPS steps of `path` through the kernels and through the
    plain versions from the same seeded state; raises past STEP_TOL (float32)
    or on any bit (bf16), or on a kernel count other than RUNS_PER_STEP's."""
    finals = {}
    for mode in ("cuda", "eager"):
        mcfg, scene = _cfg_scene(path, dev, kernels=mode)
        state = seeded_state(scene, mcfg, dev)
        reset_counts()
        finals[mode] = make_run_fn(mcfg)(state, scene, PARITY_STEPS)
        torch.cuda.synchronize()
        check_counts(read_counts(), path, PARITY_STEPS if mode == "cuda" else 0,
                     f"parity[{path}, {mode}]")
    names = [n for n, _ in leaves(finals["eager"])]
    got = [leaf for _, leaf in leaves(finals["cuda"])]
    ref = [leaf for _, leaf in leaves(finals["eager"])]
    per_leaf = {n: float((g.float() - r.float()).abs().max()) for n, g, r in zip(names, got, ref)}
    emit({"phase": "parity", "path": path, "grid": list(scene.shape), "steps": PARITY_STEPS,
          "dtype": str(got[1].dtype), "per_leaf_max_abs_err": per_leaf})
    if path.endswith("_bf16"):
        err = rel = bit_errors(got, ref, f"parity[{path}]")
        tol = 0.0
    else:
        err, rel = max_errors([g.float() for g in got], [r.float() for r in ref],
                              f"parity[{path}]", STEP_TOL)
        tol = STEP_TOL
    emit({"phase": "parity", "path": path, "steps": PARITY_STEPS, "max_abs_err": err,
          "max_rel_err": rel, "tol": tol})


def _base_names(prof) -> list[tuple[str, float]]:
    """The CUDA kernels a profiler saw, one (name, µs) per launch, the name
    with template arguments and parameter lists dropped (the schedule's step
    ranges are no kernels)."""
    names = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.name.startswith("ProfilerStep"):
            continue
        name = evt.name
        for _ in range(8):  # innermost first: nested <...> and (...)
            name = re.sub(r"<[^<>]*>|\([^()]*\)", "", name)
        names.append((name.strip(), float(evt.time_range.elapsed_us())))
    return names


def _trace_two_steps(sim) -> list[tuple[str, float]]:
    """The CUDA kernels of sim.step(2) under torch.profiler (_base_names).
    Tracing starts a cycle before the one read (warmup): a trace begun with
    the first of its launches can miss that launch."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            sim.step(2)
            torch.cuda.synchronize()
            prof.step()
    return _base_names(prof)


def _check_trace(timed, what: str, want: dict[str, int]) -> dict[str, int] | None:
    """One trace of two steps (_trace_two_steps) against what they launch:
    the port kernels of `want` exactly as often as it says (PROFILE_COUNTS,
    KK_PROFILE_COUNTS, JACOBI_PROFILE_COUNTS) and one PyTorch elementwise add
    a step (the step
    counter), no copy or convert kernel. Returns the port kernels' counts;
    None where the trace holds only those kernels, none too often, but
    misses a launch (a profiler that dropped records, or traced nothing);
    raises AssertionError on any other kernel or a launch too many."""
    names = [n for n, _ in timed]
    device_us = {n: sum(us for m, us in timed if m == n) for n in set(names)}
    port = [n for n in names if any(k in n for k in PORT_KERNELS)]
    other = [n for n in names if n not in port]
    bad = [n for n in names if re.search(r"copy|convert|to_copy", n, re.IGNORECASE)]
    counts = {n: names.count(n) for n in sorted(set(names))}
    emit({"phase": "profile", "run": what, "steps": 2, "kernels": counts,
          "device_us": device_us, "device_us_total": sum(device_us.values())})
    if bad or len(other) > 2 or len(set(other)) > 1 or any("elementwise" not in n for n in other):
        raise AssertionError(f"profile[{what}]: kernels other than the port's and one add a "
                             f"step: {sorted(set(other))}; copy/convert: {sorted(set(bad))}")
    fused = {k: sum(re.search(rf"\b{k}$", n) is not None for n in names) for k in want}
    unexpected = [n for n in set(port)
                  if not any(re.search(rf"\b{k}$", n) and c for k, c in want.items())]
    if unexpected or any(fused[k] > c for k, c in want.items()):
        raise AssertionError(f"profile[{what}]: {fused}, expected {want}; other port "
                             f"kernels: {sorted(unexpected)}")
    if fused != want or len(other) < 2:
        return None
    return {n: names.count(n) for n in set(port)}


def check_profile(dev) -> None:
    """torch.profiler over two headline steps at each dtype, two kk steps and
    two cip_jacobi2 steps at float32 (after two traced as its warm-up), held
    to _check_trace, the
    same port kernels in the headline at both dtypes. A host's profiler may
    drop a launch from a trace: a trace that only misses launches is taken
    again, up to PROFILE_TRACES in all, and the phase fails if none is
    whole, an empty trace included."""
    seen = {}
    runs = (("float32", {"dtype": "float32"}, PROFILE_COUNTS),
            ("bfloat16", {"dtype": "bfloat16"}, PROFILE_COUNTS),
            ("kk", {"scheme": "kk"}, KK_PROFILE_COUNTS),
            ("cip_jacobi2", {"pressure_solver": "jacobi"}, JACOBI_PROFILE_COUNTS))
    for what, kw, want in runs:
        sim = FluidSimulator.create(bc_num=SCENE, resolution=RES, device="cuda", **kw)
        sim.step(2)
        torch.cuda.synchronize()
        for _ in range(PROFILE_TRACES):
            seen[what] = _check_trace(_trace_two_steps(sim), what, want)
            if seen[what] is not None:
                break
        else:
            raise AssertionError(f"profile[{what}]: each of {PROFILE_TRACES} traces missed a "
                                 f"launch of two steps (or held none)")
        del sim
    if seen["float32"] != seen["bfloat16"]:
        raise AssertionError(f"profile: bf16 kernels {seen['bfloat16']} differ from float32 "
                             f"{seen['float32']}")


def run_path(path: str, dev) -> dict[str, int]:
    """`path` through FluidSimulator: WARMUP_STEPS, then RUN_STEPS timed
    steps fenced by a synchronize and a device→host read, then the eager
    path's steps/s. Returns the kernel counts of the kernel path's run."""
    bc, res, kw = PATHS[path]
    sim = FluidSimulator.create(bc_num=bc, resolution=res, device="cuda", **kw)
    reset_counts()
    sim.step(WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(RUN_STEPS)
    torch.cuda.synchronize()
    probe = float(sim.state.v[0, res, res // 2])  # device→host read fences the run
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, path, WARMUP_STEPS + RUN_STEPS, f"run[{path}]")
    for name, leaf in leaves(sim.state):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"run[{path}]: state leaf {name} is not finite")
    if int(sim.state.step) != WARMUP_STEPS + RUN_STEPS or not np.isfinite(probe):
        raise AssertionError(f"run[{path}]: step count {int(sim.state.step)}, probe {probe}")
    max_v = float(sim.state.v.float().abs().max())
    if max_v <= 1e-3:
        raise AssertionError(f"run[{path}]: no flow developed")
    dtype = str(sim.state.v.dtype)
    del sim

    eager = FluidSimulator.create(bc_num=bc, resolution=res, device="cuda", kernels="eager",
                                  **kw)
    eager.step(WARMUP_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eager.step(EAGER_STEPS)
    torch.cuda.synchronize()
    float(eager.state.v[0, res, res // 2])
    eager_seconds = time.perf_counter() - t1
    emit({"phase": "run", "path": path, "dtype": dtype, "grid": [2 * res, res],
          "steps": RUN_STEPS, "seconds": seconds, "steps_per_s": RUN_STEPS / seconds,
          "eager_steps": EAGER_STEPS, "eager_steps_per_s": EAGER_STEPS / eager_seconds,
          "max_abs_v": max_v, "launches": counts})
    return counts


def _cli(argv: list[str], what: str) -> tuple[str, dict[str, int], float]:
    """cli.main(argv) in this process, the counters zeroed just before:
    (its standard output, the counts, seconds)."""
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    if "NaN DETECTED" in out:
        raise AssertionError(f"{what}: NaN in the log:\n{out}")
    return out, read_counts(), seconds


def _check_frames(out_dir: Path, what: str) -> int:
    from PIL import Image

    frames = sorted(out_dir.glob("frame_*.png"))
    if len(frames) != CLI_STEPS_A // CLI_EVERY:
        raise AssertionError(f"{what}: frames {[f.name for f in frames]}")
    for f in frames:
        with Image.open(f) as im:
            arr = np.asarray(im.convert("RGB"))
        if arr.shape != (RES, 2 * RES, 3) or not (arr != arr[0, 0]).any():
            raise AssertionError(f"{what}: {f.name} is {arr.shape}, uniform or misshaped")
    return len(frames)


def _check_views(sim, what: str) -> float:
    """The four views rendered on the card against the same state and scene
    rendered on the CPU, and each view's 8-bit image from the card (V1)
    bit-equal to the NumPy path's image of the same frame; returns the
    largest difference of the views."""
    cpu_state = state_from_numpy(state_to_numpy(sim.state), "cpu", sim.cfg.dtype)
    cpu_scene = Scene(*(t.cpu() for t in sim.scene))
    worst = 0.0
    for vis in range(4):
        got = sim.render(vis)
        if got.device.type != "cuda" or got.dtype != torch.float32:
            raise AssertionError(f"{what}: view {vis} is {got.dtype} on {got.device}")
        ref = render_rgb(cpu_state, cpu_scene, sim.cfg, vis)
        err = float((got.cpu() - ref).abs().max())
        if not err <= VIEW_TOL or not bool(torch.isfinite(ref).all()):
            raise AssertionError(f"{what}: view {vis} differs from the CPU's by {err}")
        if not np.array_equal(to_image(got), to_image(got.cpu().numpy())):
            raise AssertionError(f"{what}: view {vis}'s image from the card differs from NumPy's")
        worst = max(worst, err)
    return worst


def _resume_legs(tmp: Path, dtype: str, headline: float) -> dict[str, int]:
    """Run A (21 steps: frames and logs every 10, dump, checkpoint), run B
    (--resume A for 9 steps: dump step_000030, checkpoint), run C (30
    straight steps through FluidSimulator); B's state bit-equal to C's on
    every leaf, each CLI run launching the main path's kernels once a step;
    C's views on the card against the CPU's; the CLI timed with frames and
    logs off beside phase 6's headline. Returns the CLI runs' counts."""
    path = "cip" if dtype == "float32" else "cip_bf16"
    flags = [*CLI_FLAGS, "--dtype", dtype]
    ck_a, ck_b = tmp / "A.npz", tmp / "B.npz"
    out_a, counts_a, sec_a = _cli(
        [*flags, "--steps", str(CLI_STEPS_A), "--frame-every", str(CLI_EVERY), "--log-every",
         str(CLI_EVERY), "--dump-fields", "--checkpoint", str(ck_a), "--output",
         str(tmp / "A")], f"cli[{dtype}] A")
    check_counts(counts_a, path, CLI_STEPS_A, f"cli[{dtype}] A", CLI_STEPS_A // CLI_EVERY)
    logs = [line for line in out_a.splitlines() if line.startswith("step ")]
    if [line.split(":")[0] for line in logs] != ["step 10", "step 20"] or not all(
            "div_rms=" in line for line in logs):
        raise AssertionError(f"cli[{dtype}] A: log lines {logs}")
    frames = _check_frames(tmp / "A", f"cli[{dtype}] A")
    if not (tmp / "A" / f"step_{CLI_STEPS_A:06d}.npz").exists():
        raise AssertionError(f"cli[{dtype}] A: no dump")
    emit({"phase": "cli", "run": "A", "dtype": dtype, "steps": CLI_STEPS_A, "seconds": sec_a,
          "frames": frames, "logs": logs, "checkpoint_bytes": ck_a.stat().st_size,
          "launches": counts_a})

    out_b, counts_b, sec_b = _cli(
        ["--resume", str(ck_a), "--steps", str(CLI_STEPS_B), "--dump-fields", "--checkpoint",
         str(ck_b), "--output", str(tmp / "B")], f"cli[{dtype}] B")
    check_counts(counts_b, path, CLI_STEPS_B, f"cli[{dtype}] B")
    total = CLI_STEPS_A + CLI_STEPS_B
    dump = tmp / "B" / f"step_{total:06d}.npz"
    if not dump.exists():
        raise AssertionError(f"cli[{dtype}] B: no {dump.name} in {list((tmp / 'B').iterdir())}")

    sim = FluidSimulator.create(bc_num=SCENE, resolution=RES, dtype=dtype)
    sim.step(total)
    resumed, _, _ = fio.load_checkpoint(ck_b, sim.device)
    if int(resumed.step) != total or int(sim.state.step) != total:
        raise AssertionError(f"cli[{dtype}]: steps {int(resumed.step)}, {int(sim.state.step)}")
    names = [name for name, _ in leaves(sim.state)]
    if names != [name for name, _ in leaves(resumed)]:
        raise AssertionError(f"cli[{dtype}]: leaves {names}")
    bit_errors([leaf for _, leaf in leaves(resumed)], [leaf for _, leaf in leaves(sim.state)],
               f"cli[{dtype}] {CLI_STEPS_A} + {CLI_STEPS_B} steps against {total}")
    view_err = _check_views(sim, f"cli[{dtype}] views")
    del sim, resumed
    emit({"phase": "cli", "run": "B", "dtype": dtype, "steps": CLI_STEPS_B, "seconds": sec_b,
          "dump": dump.name, "resume_bit_equal": names, "views_max_abs_err": view_err,
          "launches": counts_b})

    out_t, counts_t, _ = _cli([*flags, "--steps", str(HEADLINE_STEPS), "--output",
                               str(tmp / "T")], f"cli[{dtype}] timed")
    check_counts(counts_t, path, HEADLINE_STEPS, f"cli[{dtype}] timed")
    rate = float(re.search(r"\(([0-9.]+) steps/s\)", out_t.splitlines()[-1]).group(1))
    if rate < CLI_RATE_FLOOR * headline:
        raise AssertionError(f"cli[{dtype}]: {rate} steps/s against the headline's {headline}")
    emit({"phase": "cli", "run": "timed", "dtype": dtype, "steps": HEADLINE_STEPS,
          "steps_per_s": rate, "headline_steps_per_s": headline, "ratio": rate / headline,
          "launches": counts_t})
    return {name: counts_a[name] + counts_b[name] + counts_t[name] for name in counts_a}


def check_view(dev, table) -> None:
    """V1 on random frames in [-0.2, 1.2] with NaN and ±inf cells at
    VIEW_SHAPES: bit-equal to the NumPy path of ``to_image`` and to the plain
    version, timed beside its bound (the frame read and the image written
    once), the plain version and the PyTorch clamp, multiply, add and cast
    to uint8 of the same frame (no flip); the first shape heads the row."""
    gen = torch.Generator(device=dev).manual_seed(1515)
    for k, shape in enumerate(VIEW_SHAPES):
        rgb = torch.rand((*shape, 3), generator=gen, device=dev) * 1.4 - 0.2
        rgb.view(-1)[::97] = float("nan")
        rgb.view(-1)[5::211] = float("inf")
        rgb.view(-1)[7::223] = -float("inf")
        got = cuda_view.to_image_cuda(rgb)
        torch.cuda.synchronize()
        with np.errstate(invalid="ignore"):  # NumPy's cast of NaN warns (and gives 0)
            ref = to_image(rgb.cpu().numpy())
        if not (np.array_equal(got.cpu().numpy(), ref)
                and torch.equal(got, cuda_view.to_image_plain(rgb))):
            raise AssertionError(f"to_image[{shape}]: differs from the NumPy path")
        ms = median_ms(lambda rgb=rgb: cuda_view.to_image_cuda(rgb))
        plain_ms = median_ms(lambda rgb=rgb: cuda_view.to_image_plain(rgb))
        library_ms = median_ms(lambda rgb=rgb: (rgb.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8))
        b = bound(rgb.numel() * (4 + 1), 0)
        name = f"_{shape[0]}x{shape[1]}"
        _row(table, "to_image", "" if k == 0 else name, 0.0, ms, plain_ms, *b,
             library_ms=library_ms)
        table["to_image"] |= {f"bound_ms{name}": b[0], f"plain_ms{name}": plain_ms,
                              f"library_ms{name}": library_ms}
        emit({"phase": "last_probe_check", "name": f"to_image{name}", "bit_equal": True,
              "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b[0],
              "share_of_bound": b[0] / ms})


def run_front_end(headlines: dict[str, float]) -> dict[str, dict[str, int]]:
    """Phase 10 (on the card: every entry point's default device): the
    CLI's resume legs at float32 and bf16, each timed beside phase 6's
    headline (`headlines`), then
    solver_residual_bench (A1 and B1 on the CIP path) and bf16_drift (both
    dtypes) through their entry points, each with its kernel runs checked.
    Returns the counts by path."""
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            (Path(tmp) / dtype).mkdir()
            launches[f"cli_{dtype}"] = _resume_legs(Path(tmp) / dtype, dtype, headlines[dtype])

    a = SOLVER_ARGS
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rows = solver_residual_bench.main(
            ["--res", str(a["res"]), "--iters", ",".join(map(str, a["iters"])), "--settle",
             str(a["settle"]), "--probe", str(a["probe"]), "--steps", str(a["steps"])])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    steps = a["settle"] + 2 * a["probe"] + 2 * a["steps"]  # settle, probes, warm-up + timed
    calls = {solver: sum(len(pressure_chain(SimConfig.create(pressure_solver=solver,
                                                             n_pressure_iter=n)))
                         for n in a["iters"]) for solver in ("sor", "jacobi")}
    per_kernel = {"cip_velocity_phase": 2 * len(a["iters"]), "confinement": 2 * len(a["iters"]),
                  "cip_dye_phase": 2 * len(a["iters"]), "sor_iteration": calls["sor"],
                  "jacobi_iteration": calls["jacobi"]}
    want = {name: per_kernel.get(name, 0) * steps for name, *_ in KERNELS}
    if counts != want:
        raise AssertionError(f"solver_residual: kernel runs {counts}, expected {want}")
    for solver, n, resid, rate in rows:
        if not (np.isfinite(resid) and resid > 0 and rate > 0):
            raise AssertionError(f"solver_residual: {solver} n={n}: {resid}, {rate}")
    emit({"phase": "cli", "run": "solver_residual", "seconds": seconds, **a,
          "rows": [{"solver": s, "n_iter": n, "div_rms": r, "steps_per_s": q}
                   for s, n, r, q in rows], "launches": counts})
    launches["solver_residual"] = counts

    d = DRIFT_ARGS
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        drift = bf16_drift.main(["--res", str(d["res"]), "--steps", str(d["steps"]),
                                 "--points", str(d["points"])])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, "cip", 2 * d["steps"], "bf16_drift")  # one run a dtype
    rows = drift["drift"]
    if [row["step"] for row in rows] != bf16_drift.marks_for(d["steps"], d["points"]) or any(
            row["bf16_nan"] or not all(np.isfinite(v) for k, v in row.items() if k != "bf16_nan")
            for row in rows):
        raise AssertionError(f"bf16_drift: {drift}")
    emit({"phase": "cli", "run": "bf16_drift", "seconds": seconds, **d, "drift": rows,
          "launches": counts})
    launches["bf16_drift"] = counts
    return launches


if __name__ == "__main__":
    main()
