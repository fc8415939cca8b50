#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc. The
main path is scene 2 at res=1600 (a 3200×1600 grid): CIP advection, 3-channel
dye, vorticity confinement ε=5, red-black SOR (ω=1.3, 2 iterations), velocity
limit 10, float32 state. Phases, each printed as one JSON line:

1. device  — the card; nvidia-smi's "name, power.limit" line is printed as is.
2. build   — nvcc builds fluid2d_tpu_torch/csrc/*.cu; seconds taken.
3. kernels — each kernel against its plain PyTorch version at the main path's
             shapes on seeded random inputs: every output within
             1e-5·max(1, |ref|max); median ms of both over 20 calls (CUDA events).
4. parity  — a seeded smooth state, 4 steps with kernels="cuda" and with
             kernels="eager" on the card: every state leaf within
             2e-5·max(1, |ref|max); the kernel counters moved by 4/4/8/4.
5. run     — FluidSimulator.create(bc_num=2, resolution=1600, device="cuda"):
             2 warm-up steps, 200 timed steps ending in a synchronize and a
             device→host read; every leaf finite; steps/s, beside the eager
             path's steps/s over 20 steps.

Then the kernel table as one JSON line, and as the last line
{"ok": true, "device": {...}}. Any failure raises: the exit code is not 0 and
the last line is not printed. Without a CUDA card it exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from fluid2d_tpu_torch import FluidSimulator, SimConfig, get_scene, init_state, make_run_fn
from fluid2d_tpu_torch.ops import _build, cuda_phases, cuda_stencil

RES = 1600
SCENE = 2
KERNEL_TOL = 1e-5
STEP_TOL = 2e-5
TIMED_CALLS = 20
PARITY_STEPS = 4
RUN_STEPS = 200
WARMUP_STEPS = 2
EAGER_STEPS = 20

# name, wrapper, source, TPU kernel it replaces, runs per step
KERNELS = (
    ("cip_velocity_phase", cuda_phases.cip_velocity_phase_cuda,
     "fluid2d_tpu_torch/csrc/cip_phases.cu", "fluid2d_tpu/ops/pallas_phases.py:490", 1),
    ("confinement", cuda_phases.confinement_cuda,
     "fluid2d_tpu_torch/csrc/confinement.cu", "fluid2d_tpu/ops/pallas_phases.py:1925", 1),
    ("sor_iteration", cuda_stencil.sor_iteration_cuda,
     "fluid2d_tpu_torch/csrc/sor.cu", "fluid2d_tpu/ops/pallas_stencil.py:1238", 2),
    ("cip_dye_phase", cuda_phases.cip_dye_phase_cuda,
     "fluid2d_tpu_torch/csrc/cip_phases.cu", "fluid2d_tpu/ops/pallas_phases.py:1631", 1),
)


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


def median_ms(fn) -> float:
    """Median device time of one call over TIMED_CALLS calls (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(TIMED_CALLS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_cases(scene, cfg, dev):
    """Per kernel: a list of (variant, wrapper call, plain call) on seeded
    random inputs at the main path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    shape = scene.shape

    def rnd(lead, scale, offset=0.0):
        return scale * torch.randn((*lead, *shape), generator=gen, device=dev) + offset

    p, pa = rnd((), 0.3), rnd((), 0.3)
    u, w = rnd((), 8.0), rnd((), 8.0)  # |v| straddles the limit of 10
    v, va = rnd((2,), 0.5), rnd((2,), 0.5)
    vg = [rnd((2,), 0.1) for _ in range(4)]
    dye, da = rnd((3,), 0.5, 0.5), rnd((3,), 0.5, 0.5)
    dg = [rnd((3,), 0.1) for _ in range(4)]
    sor = (p, pa, u, w, scene.pbc_code, scene.fluid8, cfg.sor_omega, cfg.dt, cfg.dx)
    conf = (v, va, scene.fluid8, cfg.dt, cfg.vor_eps, cfg.dx)
    vel = (v, p, va, *vg, scene, cfg.re, cfg.dt, cfg.dx)
    dyes = (dye, da, *dg, v, scene, cfg.re, cfg.dt, cfg.dx)

    def pair(wrapper, plain, args, **kw):
        return (lambda: wrapper(*args, **kw)), (lambda: plain(*args, **kw))

    return {
        "cip_velocity_phase": [("", *pair(cuda_phases.cip_velocity_phase_cuda,
                                          cuda_phases.cip_velocity_phase_plain, vel))],
        "confinement": [("", *pair(cuda_phases.confinement_cuda,
                                   cuda_phases.confinement_plain, conf))],
        "sor_iteration": [
            ("", *pair(cuda_stencil.sor_iteration_cuda, cuda_stencil.sor_iteration_plain, sor)),
            ("_v_limit", *pair(cuda_stencil.sor_iteration_cuda, cuda_stencil.sor_iteration_plain,
                               sor, v_limit=cfg.velocity_limit)),
        ],
        "cip_dye_phase": [("", *pair(cuda_phases.cip_dye_phase_cuda,
                                     cuda_phases.cip_dye_phase_plain, dyes))],
    }


def seeded_state(scene, cfg, dev):
    """The smooth seeded state of __graft_entry__.py (fluid cells only)."""
    st = init_state(scene, cfg, dev)
    x_rows, y_cols = scene.shape
    fluid = (scene.mask.cpu().numpy() == 0).astype(np.float32)
    gx = np.linspace(0, 2 * np.pi, x_rows, dtype=np.float32)[:, None]
    gy = np.linspace(0, 2 * np.pi, y_cols, dtype=np.float32)[None, :]
    u = 0.3 * np.sin(gx) * np.cos(2 * gy) * fluid
    w = 0.2 * np.cos(2 * gx) * np.sin(gy) * fluid
    dye = np.stack([0.5 + 0.4 * np.sin(k * gx) * np.cos(gy) * fluid for k in (1, 2, 3)])
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)  # noqa: E731
    return st._replace(v=as_t(np.stack([u, w])), p=as_t(0.1 * np.sin(gx + gy) * fluid),
                       dye=as_t(dye))


def reset_counts() -> None:
    for _, wrapper, *_ in KERNELS:
        wrapper.launches = 0


def read_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, wrapper, *_ in KERNELS}


def check_counts(counts: dict[str, int], steps: int, what: str) -> None:
    want = {name: per_step * steps for name, _, _, _, per_step in KERNELS}
    if counts != want:
        raise AssertionError(f"{what}: kernel runs {counts}, expected {want}")


def leaves(state):
    return [(name, leaf) for name, leaf in zip(state._fields, state) if leaf is not None]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
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

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib_path.name})

    # 3. kernels against their plain versions at the main path's shapes
    cfg = SimConfig.create(resolution=RES)
    scene = get_scene(SCENE, RES, dev)
    table = {}
    for name, variants in kernel_cases(scene, cfg, dev).items():
        for variant, kernel, plain in variants:
            got = kernel()
            torch.cuda.synchronize()
            err, rel = max_errors(got, plain(), name + variant, KERNEL_TOL)
            ms, plain_ms = median_ms(kernel), median_ms(plain)
            emit({"phase": "kernel", "name": name + variant, "max_abs_err": err,
                  "max_rel_err": rel, "tol": KERNEL_TOL, "ms": ms, "plain_ms": plain_ms,
                  "grid": list(scene.shape)})
            row = table.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row.setdefault("ms", ms)
            row.setdefault("plain_ms", plain_ms)
            if variant:
                row["ms" + variant], row["plain_ms" + variant] = ms, plain_ms

    # 4. parity of the slice: kernels against the eager path, 4 steps
    finals = {}
    for mode in ("cuda", "eager"):
        mcfg = SimConfig.create(resolution=RES, kernels=mode)
        state = seeded_state(scene, mcfg, dev)
        reset_counts()
        finals[mode] = make_run_fn(mcfg)(state, scene, PARITY_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(counts, PARITY_STEPS if mode == "cuda" else 0, f"parity[{mode}]")
    names = [n for n, _ in leaves(finals["eager"])]
    got = [leaf.float() for _, leaf in leaves(finals["cuda"])]
    ref = [leaf.float() for _, leaf in leaves(finals["eager"])]
    per_leaf = {n: float((g - r).abs().max()) for n, g, r in zip(names, got, ref)}
    emit({"phase": "parity", "steps": PARITY_STEPS, "per_leaf_max_abs_err": per_leaf})
    err, rel = max_errors(got, ref, "parity", STEP_TOL)
    emit({"phase": "parity", "steps": PARITY_STEPS, "max_abs_err": err, "max_rel_err": rel,
          "tol": STEP_TOL})

    # 5. the main path through the user's entry point
    sim = FluidSimulator.create(bc_num=SCENE, resolution=RES, scheme="cip", device="cuda")
    reset_counts()
    sim.step(WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(RUN_STEPS)
    torch.cuda.synchronize()
    probe = float(sim.state.v[0, RES, RES // 2])  # device→host read fences the run
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, WARMUP_STEPS + RUN_STEPS, "run")
    for name, leaf in leaves(sim.state):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"run: state leaf {name} is not finite")
    if int(sim.state.step) != WARMUP_STEPS + RUN_STEPS or not np.isfinite(probe):
        raise AssertionError(f"run: step count {int(sim.state.step)}, probe {probe}")
    if float(sim.state.v.abs().max()) <= 1e-3:
        raise AssertionError("run: no flow developed")

    eager = FluidSimulator.create(bc_num=SCENE, resolution=RES, scheme="cip", device="cuda",
                                  kernels="eager")
    eager.step(WARMUP_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eager.step(EAGER_STEPS)
    torch.cuda.synchronize()
    float(eager.state.v[0, RES, RES // 2])
    eager_seconds = time.perf_counter() - t1
    emit({"phase": "run", "grid": list(scene.shape), "steps": RUN_STEPS, "seconds": seconds,
          "steps_per_s": RUN_STEPS / seconds, "eager_steps": EAGER_STEPS,
          "eager_steps_per_s": EAGER_STEPS / eager_seconds,
          "max_abs_v": float(sim.state.v.abs().max()), "launches": counts})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": counts[name], **table[name]}
        for name, _, source, replaces, _ in KERNELS
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
