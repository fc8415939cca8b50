"""frames: a user watching. One frame is ``step(steps_per_frame)``, then
the view ``view`` rendered and brought to the host as an 8-bit image, as
the port's viewer does; the next frame starts when the image is in hand.
A call's output is the image."""

import numpy as np

from bench_port.reference import view as ref_view
from bench_port.session import span

COUNTS = "calls"  # a call is a frame


def steps_per_call(traffic: dict) -> int:
    return traffic["steps_per_frame"]


def call(sess, traced: bool):
    from fluid2d_tpu_torch.utils import viz

    sim = sess.sim
    with span("step_call", traced):
        sim.step(sess.k)
    with span("render", traced):
        rgb = sim.render(sess.traffic["view"])
    with span("to_image", traced):
        return viz.to_image(rgb)


def numbers(ref, state: dict, traffic: dict, output) -> dict:
    """``frame_diff_pct``: the share, in %, of the frame's 8-bit values that
    differ from the reference's frame of `state`."""
    img = ref_view.to_image(ref_view.render(state, ref.wall, traffic["view"]))
    if output is None or output.shape != img.shape or output.dtype != img.dtype:
        return {"frame_diff_pct": 100.0}
    return {"frame_diff_pct": 100.0 * float(np.count_nonzero(output != img)) / img.size}
