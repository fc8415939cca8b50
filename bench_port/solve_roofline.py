"""The least time one step's pressure solve can take on the card: its bytes
at the published HBM rate, or its element operations at the published
float32 rate, whichever is larger (the rates of :mod:`bench_port.roofline`).

The solve is the configuration's ``n_pressure_iter`` iterations and the
velocity limiter after them, as the plain reference's ``pressure()`` runs
them. Both counts come from the configuration and the scene's mask alone,
never from the program: the share stays the same whatever kernels
implement the solve, and a solve fused into fewer calls reads the same
least bytes as one split over several.

Bytes: ``p`` and the velocity's two planes read at every cell, ``p_alt``
read only where the first iteration keeps it (at walls for Jacobi; off the
odd fluid cells for red-black SOR), the mask at one byte a cell (every
pressure BC code and the wall flags follow from it), and ``p``, ``p_alt``
and the limited velocity written once.

Element operations: the aten operations of the reference's ``pressure()``
on shape-only tensors, weighted as :mod:`bench_port.roofline` weighs the
step's.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.roofline import FP32_FLOPS_PER_S, HBM_BYTES_PER_S, _cells, _Counter

__all__ = ["solve_bytes", "solve_elops", "least_solve_s"]


def solve_bytes(cfg: dict, mask: np.ndarray) -> int:
    """Least bytes one step's pressure solve of `cfg` moves on the scene
    `mask` (4 bytes a cell a plane at float32, or the transport dtype's
    size)."""
    item = torch.empty((), dtype=getattr(torch, cfg.get("dtype", "float32"))).element_size()
    n = _cells(mask)
    kept = "wall" if cfg["pressure_solver"] == "jacobi" else "not_odd_fluid"
    read = 3 * n["all"] + n[kept]  # p, u, w; p_alt where it is kept
    written = 4 * n["all"]  # p, p_alt, the limited u, w
    return (read + written) * item + n["all"]  # the mask


def solve_elops(cfg: dict, scene: dict) -> float:
    """Weighted element operations of one step's pressure solve of `cfg`
    on `scene` (the arrays of :mod:`bench_port.reference.scenes`), counted
    on shape-only tensors: nothing is computed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from bench_port.reference.step import Reference

    with FakeTensorMode():
        x_res, y_res = torch.as_tensor(scene["mask"]).shape
        ref = Reference(cfg, scene, "cpu")
        p, p_alt, v = (torch.empty((x_res, y_res)), torch.empty((x_res, y_res)),
                       torch.empty((2, x_res, y_res)))
        counter = _Counter()
        with counter:
            ref.pressure(p, p_alt, v)
    return counter.total


def least_solve_s(cfg: dict, scene: dict) -> dict[str, float]:
    """The least seconds the solve takes by each count and the larger of
    the two (``least_s``), with the counts themselves."""
    nbytes = solve_bytes(cfg, scene["mask"])
    elops = solve_elops(cfg, scene)
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, elops / FP32_FLOPS_PER_S
    return {"bytes": nbytes, "elops": elops, "bytes_s": byte_s, "elops_s": op_s,
            "least_s": max(byte_s, op_s)}
