"""steps: a long offline run. The host calls ``FluidSimulator.step(K)``
(``steps_per_call``) again and again, as the port's CLI does between two
frames or logs, and reads its clock between calls; at the end of the
window it stops calling, synchronizes and reads one value, so the queued
launches drain inside the window. A call has no output beyond the state."""

from bench_port.session import span

COUNTS = "steps"  # what a run's `attempted` counts


def steps_per_call(traffic: dict) -> int:
    return traffic["steps_per_call"]


def call(sess, traced: bool):
    with span("step_call", traced):
        sess.sim.step(sess.k)


def numbers(ref, state: dict, traffic: dict, output) -> dict:
    """The check's numbers on the call's output, beside the state's."""
    return {}
