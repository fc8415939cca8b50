"""Red-black SOR iteration: the CUDA kernel and its plain PyTorch version.

Source note.
  Replaces: ``fluid2d_tpu/ops/pallas_stencil.py:sor_iteration_pallas``
  (core ``_sor_core``) — only what it computes, not its fetch variants
  (halo triples, element windows, sliding DMA) or tile cost model.
  Kernel: ``fluid2d_tpu_torch/csrc/sor.cu``, one thread per cell, three
  launches (BC, odd sweep, even sweep in place; the limiter rides the
  even-sweep launch).
  Bound on the H100: bytes. Per iteration it reads p, p_alt, u, w and two
  int8 planes and writes two (four with the limiter) f32 planes, at about
  25 flops per cell: far below the card's flop:byte balance.
  What the design does about it: nothing yet. Each launch re-reads its
  inputs from device memory (the neighbours mostly hit L1/L2); fusing the
  three launches with a per-tile halo is later work.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.launch import launch, on_cpu, recip32, require
from fluid2d_tpu_torch.ops.limiters import limit_vector_norm
from fluid2d_tpu_torch.ops.pressure import sor_pressure_iteration

__all__ = ["sor_iteration_cuda", "sor_iteration_plain"]


class _SorMasks:
    """The three scene leaves ``sor_pressure_iteration`` reads, rebuilt
    from the kernel's operands (parity is the global (i + j) % 2)."""

    def __init__(self, pbc_code: torch.Tensor, fluid8: torch.Tensor):
        x_rows, y_cols = fluid8.shape
        ii = torch.arange(x_rows, device=fluid8.device)[:, None]
        jj = torch.arange(y_cols, device=fluid8.device)[None, :]
        odd = (ii + jj) % 2 == 1
        fluid = fluid8 != 0
        self.pbc_code = pbc_code
        self.odd_fluid = fluid & odd
        self.even_fluid = fluid & ~odd


def sor_iteration_plain(p_cur, p_alt, u, w, pbc_code, fluid8, omega: float, dt: float,
                        dx: float, *, v_limit: float | None = None):
    """One SOR iteration composed from the eager ops, exactly as
    ``fluid2d_tpu/ops/pressure.py`` and ``models/common.py:146`` compose
    them. Returns ``(p_cur, p_alt)``, plus the norm-limited ``(2, X, Y)``
    velocity when `v_limit` is given."""
    pair = sor_pressure_iteration(p_cur, p_alt, u, w, _SorMasks(pbc_code, fluid8), omega, dt, dx)
    if v_limit is None:
        return pair
    return (*pair, limit_vector_norm(torch.stack([u, w]), v_limit))


def sor_iteration_cuda(p_cur, p_alt, u, w, pbc_code, fluid8, omega: float, dt: float,
                       dx: float, *, v_limit: float | None = None):
    """One red-black SOR iteration (pressure BC, odd sweep, even sweep),
    with the velocity-norm limiter folded in when `v_limit` is given.

    CPU tensors take :func:`sor_iteration_plain`. CUDA tensors launch
    ``csrc/sor.cu``; anything the kernel does not take (dtype, shape,
    layout, mixed devices) raises. Outputs are fresh tensors.
    """
    if on_cpu(p_cur, "sor_iteration_cuda"):
        return sor_iteration_plain(p_cur, p_alt, u, w, pbc_code, fluid8, omega, dt, dx,
                                   v_limit=v_limit)
    dev = p_cur.device
    x_rows, y_cols = p_cur.shape
    plane = (x_rows, y_cols)
    f32, i8 = torch.float32, torch.int8
    ptrs = [
        require(p_cur, "p_cur", plane, f32, dev),
        require(p_alt, "p_alt", plane, f32, dev),
        require(u, "u", plane, f32, dev),
        require(w, "w", plane, f32, dev),
        require(pbc_code, "pbc_code", plane, i8, dev),
        require(fluid8, "fluid8", plane, i8, dev),
    ]
    p_out = torch.empty_like(p_cur)
    p_bc = torch.empty_like(p_cur)
    v_lim = None if v_limit is None else torch.empty((2, x_rows, y_cols), dtype=f32, device=dev)
    launch(
        "f2d_sor_iteration", dev,
        *ptrs, p_out.data_ptr(), p_bc.data_ptr(), 0 if v_lim is None else v_lim.data_ptr(),
        x_rows, y_cols, omega, 1.0 - omega, dx, recip32(8 * dt),
        0.0 if v_limit is None else v_limit,
    )
    sor_iteration_cuda.launches += 1
    if v_lim is None:
        return p_out, p_bc
    return p_out, p_bc, v_lim


sor_iteration_cuda.launches = 0  # kernel runs (any number of __global__ launches each)
