"""host_step_s: host seconds a step inside ``step(2)``, each call started on
an empty launch queue: the launch path (checks, allocation, the kernel
calls), whether or not the device hides it."""

import time

from bench_port.session import sync


def probe(sess, calls: int) -> list[float]:
    out = []
    for _ in range(calls):
        sync(sess.sim)
        t0 = time.perf_counter()
        sess.sim.step(2)
        out.append((time.perf_counter() - t0) / 2)
    sync(sess.sim)
    return out
