"""host_us_per_step: mean host microseconds a step inside step(2), each call
started on an empty launch queue (the launch path: checks, allocation, the
kernel calls)."""

from bench_port.stats import mean


def read(record):
    xs = record.get("host_step_s")
    return 1e6 * mean(xs) if xs else None
