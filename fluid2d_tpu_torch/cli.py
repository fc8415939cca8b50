"""Command-line interface of the port (port of ``fluid2d_tpu/cli.py``).

    python -m fluid2d_tpu_torch.cli -bc 2 -res 1600 --steps 1000 --frame-every 50

The reference CLI's flag surface (``main.py:11-51``) plus what a headless
host needs: a bounded step count, PNG frames (and a GIF) instead of a GUI
window, field dumps, ``.npz`` checkpoints that either package resumes, and
periodic diagnostics. The reference's keys map to flags: ``s``
(screenshot) → ``--frame-every``, ``d`` (field dump) → ``--dump-fields`` /
``--checkpoint``, ``v`` (cycle vis) → ``-vis``; ``--interactive`` opens
the matplotlib viewer.

``--device`` defaults to ``cuda`` and raises when no card is there; the
kernels run on the card, the plain PyTorch versions with ``--device cpu``
or ``--kernels eager``. Nothing moves to the CPU unasked.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from pathlib import Path

# Fresh-run defaults for the flags whose "explicitly passed?" status
# matters on --resume. The parser uses argparse.SUPPRESS as the default
# (the attribute is simply absent when a flag wasn't typed), so an
# explicitly re-passed default value is still recognized as explicit —
# e.g. `--resume ckpt --pressure-iters 2` restores 2 on a checkpoint
# saved with 4. resolve_args() fills the absentees in from this table.
DEFAULTS = {
    "boundary_condition": None,  # None ⇔ "use the checkpoint's scene" on resume
    "reynolds_num": 1_000_000.0,
    "resolution": 400,
    "time_step": 0.0,
    "vorticity_confinement": 5.0,
    "advection_scheme": "cip",
    "no_dye": False,
    "pressure_solver": "sor",
    "sor_omega": 1.3,
    "pressure_iters": 2,
    "kernels": "auto",
    "dtype": "float32",
    "mask_image": "",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="2D fluid simulator on one CUDA card (PyTorch)")
    unset = argparse.SUPPRESS
    parser.add_argument("-bc", "--boundary_condition", type=int,
                        choices=[1, 2, 3, 4, 5, 6], default=unset,
                        help="Boundary condition scene number (default 1)")
    parser.add_argument("-re", "--reynolds_num", type=float, default=unset,
                        help="Reynolds number (default 1e6)")
    parser.add_argument("-res", "--resolution", type=int, default=unset,
                        help="Resolution of y-axis (grid is 2·res × res; default 400)")
    parser.add_argument("-dt", "--time_step", type=float, default=unset,
                        help="Time step (0 → 0.05/resolution)")
    parser.add_argument("-vis", "--visualization", type=int,
                        choices=[0, 1, 2, 3], default=0,
                        help="0: velocity norm + pressure, 1: pressure, "
                             "2: vorticity, 3: dye")
    parser.add_argument("-vc", "--vorticity_confinement", type=float, default=unset,
                        help="Vorticity confinement weight (default 5.0); 0.0 disables")
    parser.add_argument("-scheme", "--advection_scheme", type=str,
                        choices=["upwind", "kk", "cip"], default=unset,
                        help="Advection scheme (default cip)")
    parser.add_argument("-no_dye", "--no_dye", action="store_true", default=unset,
                        help="Disable dye transport")
    parser.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; raises without a card) or cpu (the plain "
                             "PyTorch versions of the kernels)")
    # --- additions over the reference (headless operation) ---------------
    parser.add_argument("--steps", type=int, default=1000,
                        help="Number of simulation steps to run")
    parser.add_argument("--frame-every", type=int, default=0,
                        help="Write a PNG frame every N steps (0 = off); "
                             "the reference renders every 5th step")
    parser.add_argument("--gif", type=str, default="",
                        help="Also collect the frames into an animated GIF here")
    parser.add_argument("--output", type=str, default="output",
                        help="Output directory for frames/dumps")
    parser.add_argument("--dump-fields", action="store_true",
                        help="Dump v/p(/dye) .npz at the end (reference 'd' key)")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="Write a full-state .npz checkpoint here at the end")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="Also checkpoint every N steps (requires --checkpoint); "
                             "with --abort-on-nan this gives crash-and-resume safety")
    parser.add_argument("--abort-on-nan", action="store_true",
                        help="Stop (after the last good checkpoint) if fields go NaN")
    parser.add_argument("--resume", type=str, default="",
                        help="Resume from a .npz checkpoint written by --checkpoint "
                             "(of this CLI or of the JAX package's)")
    parser.add_argument("--pressure-solver", type=str, choices=["sor", "jacobi"],
                        default=argparse.SUPPRESS,
                        help="Pressure Poisson solver (default sor)")
    parser.add_argument("--kernels", type=str, choices=["auto", "cuda", "eager"],
                        default=argparse.SUPPRESS,
                        help="Compute path: auto (the CUDA kernels on the card, the plain "
                             "versions on the CPU), cuda (the kernels; refuses the CPU), "
                             "or eager (the plain PyTorch versions)")
    parser.add_argument("--dtype", type=str, choices=["float32", "bfloat16"],
                        default=argparse.SUPPRESS,
                        help="Transport (storage) dtype of the state fields; arithmetic "
                             "stays float32 (default float32 = reference parity)")
    parser.add_argument("--sor-omega", type=float, default=argparse.SUPPRESS,
                        help="SOR relaxation factor (default 1.3)")
    parser.add_argument("--pressure-iters", type=int, default=argparse.SUPPRESS,
                        help="Pressure iterations per step (default 2)")
    parser.add_argument("--log-every", type=int, default=0,
                        help="Log steps/sec and field diagnostics every N steps")
    parser.add_argument("--mask-image", type=str, default=argparse.SUPPRESS,
                        help="Obstacle silhouette: a grayscale image path or a "
                             "bundled asset name (dragon, rabbit, aircraft); "
                             "replaces the -bc scene")
    parser.add_argument("--profile", type=str, default="", metavar="DIR",
                        help="Trace the run loop with torch.profiler and write a Chrome "
                             "trace to DIR/trace.json: the port's f2d.* spans (step, phase "
                             "wrappers, launches, the image's copy and conversion) beside "
                             "the kernels")
    parser.add_argument("--interactive", action="store_true",
                        help="Open an interactive window (needs a display); "
                             "keys: p pause, v cycle vis, s screenshot, d dump, q quit")
    return parser


@contextlib.contextmanager
def _profiled(log_dir: str):
    """A profiler trace of the block in ``log_dir`` with the port's spans on
    (``utils/trace.py``); nothing when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    from fluid2d_tpu_torch.utils import trace
    from fluid2d_tpu_torch.utils.profiling import trace as profiler_trace

    with profiler_trace(log_dir), trace.enabled(True):
        yield
    print(f"profile written to {Path(log_dir) / 'trace.json'}")


def resolve_args(args: argparse.Namespace):
    """Fill suppressed (not-typed) flags with their fresh-run defaults and
    return the set of dests the user actually typed."""
    typed = {dest for dest in DEFAULTS if hasattr(args, dest)}
    for dest, value in DEFAULTS.items():
        if dest not in typed:
            setattr(args, dest, value)
    return typed


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    typed = resolve_args(args)

    def explicit(dest: str) -> bool:
        """Whether the user typed this flag (sentinel-default exact,
        including re-passing a value equal to the default)."""
        return dest in typed

    if args.visualization == 3 and args.no_dye:
        parser.error("-vis 3 (dye) requires dye transport; drop -no_dye")

    import numpy as np

    from fluid2d_tpu_torch.config import SimConfig, resolve_device
    from fluid2d_tpu_torch.models.simulator import FluidSimulator
    from fluid2d_tpu_torch.scenes.compile import get_scene
    from fluid2d_tpu_torch.utils.io import fields_to_numpy, write_png
    from fluid2d_tpu_torch.utils.metrics import diagnostics
    from fluid2d_tpu_torch.utils.profiling import sync
    from fluid2d_tpu_torch.utils.viz import to_image

    device = resolve_device(args.device)  # no card → raises, never the CPU unasked
    dt = args.time_step if args.time_step != 0.0 else None
    vor_eps = args.vorticity_confinement if args.vorticity_confinement != 0.0 else None

    if args.resume:
        # Scene identity and config come from the checkpoint; explicitly
        # passed CLI flags override where that is state-compatible.
        sim = FluidSimulator.load(
            args.resume,
            bc_num=args.boundary_condition,  # None ⇔ not passed
            mask_image=args.mask_image if explicit("mask_image") else None,
            device=device,
        )
        overrides = {}
        if explicit("reynolds_num"):
            overrides["re"] = args.reynolds_num
        if explicit("vorticity_confinement"):
            overrides["vor_eps"] = vor_eps
        if explicit("time_step"):
            overrides["dt"] = args.time_step
        if explicit("sor_omega"):
            overrides["sor_omega"] = args.sor_omega
        if explicit("pressure_iters"):
            overrides["n_pressure_iter"] = args.pressure_iters
        if explicit("pressure_solver"):
            overrides["pressure_solver"] = args.pressure_solver
        if explicit("kernels"):
            overrides["kernels"] = args.kernels
        if explicit("dtype"):
            overrides["dtype"] = args.dtype  # the façade re-casts the state
        for dest, flag in (("advection_scheme", "-scheme"), ("no_dye", "-no_dye"),
                           ("resolution", "-res")):
            if explicit(dest):
                print(f"note: {flag} cannot change on --resume (the checkpointed "
                      f"state's shape/fields depend on it); keeping the stored value")
        if overrides:
            import dataclasses

            sim = FluidSimulator(sim.scene, dataclasses.replace(sim.cfg, **overrides),
                                 state=sim.state, scene_meta=sim.scene_meta)
        if args.visualization == 3 and not sim.cfg.enable_dye:
            parser.error("-vis 3 (dye) but the checkpoint was written without dye")
    else:
        cfg = SimConfig.create(
            resolution=args.resolution,
            dt=dt,
            re=args.reynolds_num,
            scheme=args.advection_scheme,
            vor_eps=vor_eps,
            enable_dye=not args.no_dye,
            pressure_solver=args.pressure_solver,
            sor_omega=args.sor_omega,
            n_pressure_iter=args.pressure_iters,
            kernels=args.kernels,
            dtype=args.dtype,
        )
        bc_num = args.boundary_condition if args.boundary_condition is not None else 1
        scene = get_scene(bc_num, args.resolution, device,
                          mask_image=args.mask_image or None)
        sim = FluidSimulator(
            scene, cfg,
            scene_meta={"bc_num": bc_num,
                        "mask_image": args.mask_image or None},
        )

    cfg = sim.cfg
    # Report the scene actually in effect (on --resume the checkpoint's
    # stored identity, not the argparse default).
    scene_desc = sim.scene_meta.get("mask_image") or sim.scene_meta.get(
        "bc_num", args.boundary_condition
    )
    print(
        f"Boundary Condition: {scene_desc}\ndt: {cfg.dt}\nRe: {cfg.re}\n"
        f"Resolution: {cfg.resolution}\nScheme: {cfg.scheme}\n"
        f"Vorticity confinement: {cfg.vor_eps}"
    )

    if args.interactive:
        from fluid2d_tpu_torch.utils.viewer import run_viewer

        run_viewer(sim, vis=args.visualization, output_dir=args.output,
                   max_steps=args.steps or None)
        return

    if args.gif and not args.frame_every:
        print("note: --gif needs --frame-every to collect frames; no GIF will be written")

    out_dir = Path(args.output)
    # Each periodic action fires exactly at multiples of ITS interval:
    # every chunk ends at the nearest upcoming due-point of any action.
    intervals = [v for v in (args.frame_every, args.log_every,
                             args.checkpoint_every if args.checkpoint else 0) if v]
    done = 0
    frame_idx = 0
    gif_paths: list[Path] = []  # frame FILES — the GIF streams from disk
    aborted = False
    t0 = time.perf_counter()
    with _profiled(args.profile):
        while done < args.steps:
            stop = min([args.steps] + [done - done % v + v for v in intervals])
            sim.step(stop - done)
            done = stop
            if args.abort_on_nan:
                from fluid2d_tpu_torch.utils.metrics import has_nan

                if has_nan(sim.state):
                    print(f"** NaN detected at step {sim.step_count}; aborting "
                          f"(resume from the last checkpoint with --resume)")
                    aborted = True
                    break
            if args.checkpoint_every and args.checkpoint and done % args.checkpoint_every == 0:
                sim.save(args.checkpoint)
            if args.frame_every and done % args.frame_every == 0:
                frame = to_image(sim._render(sim.state, sim.scene, args.visualization))
                frame_path = out_dir / f"frame_{frame_idx:05d}.png"
                write_png(frame_path, frame)
                if args.gif:
                    gif_paths.append(frame_path)
                frame_idx += 1
            if args.log_every and done % args.log_every == 0:
                sync(sim.state)  # the rate of finished steps, not of queued ones
                elapsed = time.perf_counter() - t0
                diag = diagnostics(sim.state, sim.scene, cfg)
                print(f"step {sim.step_count}: {done / elapsed:8.1f} steps/s  {diag}")

        sync(sim.state)  # the card's queue drained, then one device→host read
    elapsed = time.perf_counter() - t0
    print(f"ran {done} steps in {elapsed:.2f}s ({done / elapsed:.1f} steps/s)")

    if args.dump_fields:
        out_dir.mkdir(parents=True, exist_ok=True)
        np.savez(out_dir / f"step_{sim.step_count:06d}.npz", **fields_to_numpy(sim.state))
        print(f"dumped fields to {out_dir}")
    if args.gif and gif_paths:
        from fluid2d_tpu_torch.utils.io import write_gif

        write_gif(args.gif, gif_paths)
        print(f"animation written to {args.gif} ({len(gif_paths)} frames)")
    if args.checkpoint and not aborted:
        # After a NaN abort the final state is garbage — keep the last
        # good periodic checkpoint instead of overwriting it.
        sim.save(args.checkpoint)
        print(f"checkpoint written to {args.checkpoint}")


if __name__ == "__main__":
    main()
