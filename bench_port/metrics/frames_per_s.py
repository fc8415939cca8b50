"""frames_per_s: every frame completed (an 8-bit image in hand) over the
window's whole time."""

from bench_port.stats import rate


def read(record):
    if record.get("counts") != "calls" or "window_s" not in record:
        return None
    return rate(record["calls"], record["window_s"])
