"""step_roofline: the step's least time on the card (its bytes at the
published HBM rate or its element operations at the published float32
rate, whichever is larger; bench_port.roofline, from the configuration's
shapes and the scene's mask) over the device time a step took in the
profiler window (every kernel, copy and fill), in %."""

from pathlib import Path

from bench_port.reference import scenes
from bench_port.roofline import least_step_s
from bench_port.session import sim_config


def read(record):
    tr = record.get("trace")
    if record.get("counts") != "steps" or not tr or not tr["steps"] or tr["device_op_s"] <= 0:
        return None
    cfg = record["config"]
    drawn = scenes.draw(cfg["scene"], cfg["resolution"],
                        Path(record["root"]) / "reference" / "scenes")
    least = least_step_s(sim_config(cfg), {**drawn, **scenes.derive(drawn["mask"])})
    return 100.0 * least["least_s"] / (tr["device_op_s"] / tr["steps"])
