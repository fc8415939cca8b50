"""view_s: seconds of the view alone (render and the host image), each
frame's steps finished before its clock starts."""

import time

from bench_port.session import sync


def probe(sess, frames: int) -> list[float]:
    from fluid2d_tpu_torch.utils import viz

    out = []
    for _ in range(frames):
        sess.sim.step(sess.k)
        sync(sess.sim)
        t0 = time.perf_counter()
        viz.to_image(sess.sim.render(sess.traffic["view"]))
        out.append(time.perf_counter() - t0)
    return out
