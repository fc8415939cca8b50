"""Scene 1 (``-bc 1``): inflow at the two left columns with a rainbow dye
ramp, an outflow column at the right, walls top and bottom, one cylinder."""

import numpy as np

from bench_port.reference.scenes import BLUE, CYAN, RED, YELLOW, ramp


def paint(cv, x_res: int, y_res: int) -> None:
    cv.bc[:2, :] = (1.0, 0.0)
    cv.mask[:2, :] = 2
    colours = ramp([CYAN, RED, BLUE, YELLOW] * 3, y_res)
    cv.dye[:2, :] = np.stack((colours, colours))
    cv.bc[-1, :] = 0.0
    cv.mask[-1, :] = 3
    cv.box((0, 0), (x_res, 2))
    cv.box((0, y_res - 2), (x_res, y_res))
    cv.circle((x_res // 4, y_res // 2), y_res // 18)
