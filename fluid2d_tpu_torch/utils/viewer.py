"""Interactive viewer (matplotlib; port of ``fluid2d_tpu/utils/viewer.py``)
— the reference's GGUI window (``main.py:76-134``) for hosts with a
display.

Key bindings mirror the reference: ``p`` pause, ``v`` cycle
visualization, ``s`` screenshot PNG, ``d`` dump fields to ``.npz``,
``escape``/``q`` quit. Renders every `render_every` sim steps (the
reference renders every 5th step); each frame is rendered on the state's
device and moved to the host once.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fluid2d_tpu_torch.utils.viz import VIS_MODES, to_image

__all__ = ["run_viewer"]


def run_viewer(sim, vis: int = 0, render_every: int = 5, output_dir: str = "output",
               max_steps: int | None = None) -> None:
    """Drive `sim` (a :class:`FluidSimulator`) in an interactive window."""
    try:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 5))
        fig.canvas.manager.set_window_title("Fluid Simulation")
    except Exception as exc:  # headless host or matplotlib missing
        msg = (
            f"interactive viewer needs matplotlib and a display ({exc}); "
            "use --frame-every to write PNG frames instead"
        )
        raise RuntimeError(msg) from exc

    n_vis = 4 if sim.cfg.enable_dye else 3
    if not 0 <= vis < n_vis:
        print(f"note: vis {vis} is out of range (valid: 0..{n_vis - 1}"
              f"{', 3 needs dye enabled' if not sim.cfg.enable_dye else ''});"
              " starting at vis 0")
        vis = 0
    state = {"paused": False, "vis": vis, "quit": False, "ss": 0}
    out = Path(output_dir)

    def on_key(event):
        if event.key in ("escape", "q"):
            state["quit"] = True
        elif event.key == "p":
            state["paused"] = not state["paused"]
        elif event.key == "v":
            state["vis"] = (state["vis"] + 1) % n_vis
        elif event.key == "s":
            out.mkdir(parents=True, exist_ok=True)
            sim.screenshot(out / f"{state['ss']:04d}.png", vis=state["vis"])
            state["ss"] += 1
        elif event.key == "d":
            out.mkdir(parents=True, exist_ok=True)
            from fluid2d_tpu_torch.utils.io import fields_to_numpy

            np.savez(out / f"step_{sim.step_count:06d}.npz", **fields_to_numpy(sim.state))

    fig.canvas.mpl_connect("key_press_event", on_key)
    img = ax.imshow(to_image(sim._render(sim.state, sim.scene, state["vis"])))
    ax.set_axis_off()
    plt.ion()
    plt.show()

    done = 0
    while not state["quit"] and plt.fignum_exists(fig.number):
        if not state["paused"]:
            sim.step(render_every)
            done += render_every
        img.set_data(to_image(sim._render(sim.state, sim.scene, state["vis"])))
        ax.set_title(f"step {sim.step_count}  [{VIS_MODES[state['vis']]}]", fontsize=9)
        fig.canvas.draw_idle()
        plt.pause(0.001)
        if max_steps is not None and done >= max_steps:
            break
    plt.close(fig)
