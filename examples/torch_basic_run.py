"""Minimal library usage of the PyTorch port: simulate, render, dump,
checkpoint, resume.

    python examples/torch_basic_run.py [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

parser = argparse.ArgumentParser()
parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; raises without a card) or cpu")
args = parser.parse_args()

import numpy as np

from fluid2d_tpu_torch import FluidSimulator
from fluid2d_tpu_torch.utils.io import write_png
from fluid2d_tpu_torch.utils.viz import to_image

out = Path("output/example_torch_basic")

# The reference's default configuration: CIP + dye + vorticity confinement.
sim = FluidSimulator.create(bc_num=2, resolution=200, scheme="cip", device=args.device)

sim.step(1500)  # kernel launches are queued; nothing waits on the device
print(f"at step {sim.step_count}")

# Render each visualization mode (same colormaps/scales as the reference).
for vis, name in enumerate(("norm", "pressure", "vorticity", "dye")):
    write_png(out / f"{name}.png", to_image(sim.render(vis)))

# Reference-layout field dump + full-state checkpoint & resume.
fields = sim.field_to_numpy()
print({k: v.shape for k, v in fields.items()},
      "max|v| =", float(np.abs(fields["v"]).max()))
sim.save(out / "ckpt.npz")
resumed = FluidSimulator.load(out / "ckpt.npz", device=args.device)
resumed.step(100)
print(f"resumed and advanced to step {resumed.step_count}; frames in {out}/")
