"""jacobi_roofline: the step's pressure solve's least time on the card (its
bytes at the published HBM rate or its element operations at the published
float32 rate, whichever is larger; bench_port.solve_roofline, from the
configuration and the scene's mask) over the device time a step of the
Jacobi kernel (jacobi_phase_us), in %. None where the window ran no Jacobi
kernel."""

from pathlib import Path

from bench_port import registry
from bench_port.reference import scenes
from bench_port.session import sim_config
from bench_port.solve_roofline import least_solve_s


def read(record):
    root = Path(record.get("root", registry.ROOT))
    us = registry.reader("jacobi_phase_us", root)(record)
    if not us:
        return None
    cfg = record["config"]
    drawn = scenes.draw(cfg["scene"], cfg["resolution"], root / "reference" / "scenes")
    least = least_solve_s(sim_config(cfg), {**drawn, **scenes.derive(drawn["mask"])})
    return 100.0 * least["least_s"] / (1e-6 * us)
