"""view_ms: mean milliseconds of the view alone, render(view) and the host
image, each frame's steps finished before its clock starts."""

from bench_port.stats import mean


def read(record):
    xs = record.get("view_s")
    return 1e3 * mean(xs) if xs else None
