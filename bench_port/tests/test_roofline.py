"""The step's least bytes and element operations, against hand counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import roofline
from bench_port.session import sim_config
from bench_port.reference import scenes

CIP = {"scheme": "cip", "enable_dye": True, "pressure_solver": "sor", "dtype": "float32"}
UPWIND = {"scheme": "upwind", "enable_dye": False, "pressure_solver": "sor", "dtype": "float32"}

# x = 0 inflow; walls at (1, 0) and (2, 2); x = 3 outflow. Fluid: (1, 1),
# (1, 2), (2, 0), (2, 1); the odd ones (i + j odd): (1, 2), (2, 1).
MASK = np.array([[2, 2, 2], [1, 0, 0], [0, 0, 1], [3, 3, 3]], np.uint8)


def test_cip_bytes_by_hand():
    cells, wall, not_odd_fluid, inflow = 12, 2, 10, 3
    reads = (2 * cells + cells + 2 * wall + not_odd_fluid  # v, p, v_alt, p_alt
             + 4 * cells + 4 * wall  # vx, vy and alternates
             + 3 * cells + 3 * wall  # dye and alternate
             + 6 * cells + 6 * wall)  # dyex, dyey and alternates
    writes = 32 * cells
    scene = cells + 4 * 5 * inflow  # the mask; inflow velocity and dye
    assert reads == 232
    assert roofline.step_bytes(CIP, MASK) == 4 * (reads + writes) + scene + 8 == 2544


def test_upwind_bytes_by_hand():
    # MAC keeps the old v_alt off the fluid (8 cells); no dye, no gradients
    assert roofline.step_bytes(UPWIND, MASK) == 4 * (24 + 12 + 16 + 10) + 4 * 6 * 12 + (12 + 24) + 8


def _per_cell(cfg, mask):
    """The same bytes summed cell by cell."""
    cip = cfg["scheme"] == "cip"
    total = 8
    for i in range(mask.shape[0]):
        for j in range(mask.shape[1]):
            m = mask[i, j]
            fluid, wall, odd = m == 0, m == 1, (i + j) % 2 == 1
            kept = wall if cip else not fluid
            planes = 2 + 1 + 2 * kept + (not (fluid and odd))  # v, p, v_alt, p_alt
            planes += 6  # v, v_alt, p, p_alt written
            if cip:
                planes += 4 + 4 * wall + 8
            if cfg["enable_dye"]:
                planes += 3 + 3 * kept + 6
                if cip:
                    planes += 6 + 6 * wall + 12
            total += 4 * planes + 1 + 4 * (2 + 3 * cfg["enable_dye"]) * (m == 2)
    return total


@pytest.mark.parametrize("scene,res,cfg", [(2, 10, CIP), (1, 8, UPWIND), (2, 12, UPWIND),
                                           (1, 6, {**CIP, "enable_dye": False})])
def test_bytes_of_drawn_scenes_cell_by_cell(scene, res, cfg):
    mask = scenes.draw(scene, res)["mask"]
    assert roofline.step_bytes(cfg, mask) == _per_cell(cfg, mask)


def test_alternates_count_only_where_read():
    all_fluid = np.zeros((4, 4), np.uint8)
    walled = all_fluid.copy()
    walled[0, :] = 1
    # four wall cells more: CIP reads its 15 alternate planes there and SOR's
    # p_alt at the two that were odd fluid cells and are now walls; the mask
    # and the writes are unchanged
    diff = roofline.step_bytes(CIP, walled) - roofline.step_bytes(CIP, all_fluid)
    assert diff == 4 * (15 * 4 + 2)


def test_elop_weights_by_hand():
    a, b = torch.ones(3, 4), torch.full((3, 4), 2.0)
    counter = roofline._Counter()
    with counter:
        _ = a * b + a / b  # mul 12, div 3·12, add 12
        _ = torch.cat([a, b]).sum()  # cat free, sum of 24 inputs
    assert counter.total == 12 + 36 + 12 + 24


@pytest.mark.parametrize("name,scene", [("cip1600", 2), ("upwind400", 1)])
def test_elops_scale_with_the_cells(name, scene):
    from bench_port import registry

    cfg = sim_config({**registry.config(name), "resolution": 10})
    counts = []
    for res in (10, 20):
        drawn = scenes.draw(scene, res)
        counts.append(roofline.step_elops({**cfg, "dx": 1 / res},
                                          {**drawn, **scenes.derive(drawn["mask"])}))
    assert counts[0] > 100 * 200  # well over a hundred weighted ops a cell
    assert counts[1] - 1 == pytest.approx(4 * (counts[0] - 1))  # the step counter's one add


def test_least_time_takes_the_larger_bound():
    drawn = scenes.draw(2, 10)
    cfg = sim_config({"resolution": 10, "re": 1e6, "scheme": "cip", "vor_eps": 5.0, "dt": None,
                      "enable_dye": True, "pressure_solver": "sor", "sor_omega": 1.3,
                      "n_pressure_iter": 2, "velocity_limit": 10.0, "dtype": "float32"})
    r = roofline.least_step_s(cfg, {**drawn, **scenes.derive(drawn["mask"])})
    assert r["bytes_s"] == r["bytes"] / 3.35e12 and r["elops_s"] == r["elops"] / 67e12
    assert r["least_s"] == max(r["bytes_s"], r["elops_s"])
