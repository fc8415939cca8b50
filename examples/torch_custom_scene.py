"""Build a custom boundary-condition scene from the geometry primitives
(the same builders the six built-in scenes use) and simulate it with the
PyTorch port.

    python examples/torch_custom_scene.py [--device cuda|cpu]
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

from fluid2d_tpu_torch import FluidSimulator, SimConfig, compile_scene
from fluid2d_tpu_torch.config import resolve_device
from fluid2d_tpu_torch.scenes.builder import new_scene_arrays, paint_box, paint_circle
from fluid2d_tpu_torch.utils.io import write_png
from fluid2d_tpu_torch.utils.viz import to_image

res = 160
x_res, y_res = 2 * res, res
bc, mask, dye = new_scene_arrays(x_res, y_res)

# Inflow on the left (mask code 2), with a two-tone dye.
bc[:2, :] = [1.0, 0.0]
mask[:2, :] = 2
dye[:2, : y_res // 2] = [1.2, 0.4, 0.1]
dye[:2, y_res // 2 :] = [0.1, 0.5, 1.2]

# Outflow on the right (code 3), channel walls, and some obstacles.
mask[-1, :] = 3
paint_box(bc, mask, dye, (0, 0), (x_res, 2))
paint_box(bc, mask, dye, (0, y_res - 2), (x_res, y_res))
for k in range(4):
    paint_circle(bc, mask, dye, (60 + 60 * k, 40 + 30 * (k % 2)), 12.0)

scene = compile_scene(bc, mask, dye, resolve_device(args.device))
cfg = SimConfig.create(resolution=res, re=50_000.0, scheme="cip")
sim = FluidSimulator(scene, cfg)
sim.step(2500)

out = Path("output/example_torch_custom")
write_png(out / "dye.png", to_image(sim.render(3)))
v = sim.field_to_numpy()["v"]
print(f"step {sim.step_count}, max|v| = {float(np.abs(v).max()):.3f}; image in {out}/")
