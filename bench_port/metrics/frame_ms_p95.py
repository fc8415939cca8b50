"""frame_ms_p95: the 95th percentile of every frame's time in the window,
from the frame's first step call to its image in hand."""

from bench_port.stats import percentile


def read(record):
    if record.get("counts") != "calls" or not record.get("call_s"):
        return None
    return 1e3 * percentile(record["call_s"], 95)
