"""steps_per_s: every step the window completed over the window's whole
time, the drain of the launch queue included."""

from bench_port.stats import rate


def read(record):
    if record.get("counts") != "steps" or "window_s" not in record:
        return None
    return rate(record["steps"], record["window_s"])
