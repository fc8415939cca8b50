"""kk_phase_us: device microseconds a step, in the profiler window, of the
kernels whose trace name carries the KK form (template argument ``kKK`` =
true): the KK forms of the MAC velocity phase (B2,
``mac_velocity_fused_kernel<S, true, ...>``) and of the MAC dye phase (B3,
``mac_dye_fused_kernel<S, true, ...>``). None where the window ran neither."""

import re

_KK = re.compile(r"\bmac_(?:velocity|dye)_fused_kernel<[^,<>]+,\s*true\s*[,>]")


def read(record):
    tr = record.get("trace")
    if record.get("counts") != "steps" or not tr or not tr.get("steps"):
        return None
    secs = [s for name, s in tr["device_ops"] if _KK.search(name)]
    return 1e6 * sum(secs) / tr["steps"] if secs else None
