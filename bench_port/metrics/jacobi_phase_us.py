"""jacobi_phase_us: device microseconds a step, in the profiler window, of
every instance of the fused Jacobi kernel (B1, ``jacobi_fused_kernel<...>``,
every iteration count and storage form: a six-iteration solve is a call of
four and one of two with the limiter). None where the window ran none."""

import re

_JACOBI = re.compile(r"\bjacobi_fused_kernel\b")


def read(record):
    tr = record.get("trace")
    if record.get("counts") != "steps" or not tr or not tr.get("steps"):
        return None
    secs = [s for name, s in tr["device_ops"] if _JACOBI.search(name)]
    return 1e6 * sum(secs) / tr["steps"] if secs else None
