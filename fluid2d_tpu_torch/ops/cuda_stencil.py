"""Pressure iterations, red-black SOR and Jacobi: the CUDA kernels and
their plain PyTorch versions.

Source notes.

``sor_iteration_cuda``
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

``jacobi_iteration_cuda``
  Replaces: ``fluid2d_tpu/ops/pallas_stencil.py:jacobi_iteration_pallas``
  (kernel ``_jacobi_kernel``): up to four fused Jacobi iterations, the
  limiter folded into the last.
  Kernel: ``fluid2d_tpu_torch/csrc/jacobi.cu``, one thread per cell, two
  launches per iteration (BC out of place, then the sweep over every
  not-wall cell; the limiter rides the last sweep). The BC and
  ``predict_p`` are ``csrc/pressure.cuh``, shared with SOR.
  Bound on the H100: bytes, as SOR: per iteration it reads p, p_alt, u, w
  and two int8 planes and writes two f32 planes, ~25 flops per cell.
  What the design does about it: nothing yet. The Pallas kernel keeps all
  iterations of a call in VMEM with a 2-row halo per iteration; here every
  iteration's pair goes through device memory (mostly L2 at 3200×1600,
  20 MB per plane). Fusing the iterations with a per-tile halo is later
  work.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.launch import launch, on_cpu, recip32, require
from fluid2d_tpu_torch.ops.limiters import limit_vector_norm
from fluid2d_tpu_torch.ops.pressure import jacobi_pressure_iteration, sor_pressure_iteration

__all__ = [
    "sor_iteration_cuda",
    "sor_iteration_plain",
    "jacobi_iteration_cuda",
    "jacobi_iteration_plain",
    "JACOBI_MAX_ITERS",
]

JACOBI_MAX_ITERS = 4  # iterations one jacobi_iteration_cuda call runs at most


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


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


class _JacobiMasks:
    """The two scene leaves ``jacobi_pressure_iteration`` reads, rebuilt
    from the kernel's operands."""

    def __init__(self, pbc_code: torch.Tensor, not_wall8: torch.Tensor):
        self.pbc_code = pbc_code
        self.not_wall = not_wall8 != 0


def _check_n_iters(n_iters: int) -> None:
    if not 1 <= n_iters <= JACOBI_MAX_ITERS:
        msg = f"n_iters={n_iters}: one Jacobi call runs 1..{JACOBI_MAX_ITERS} iterations"
        raise ValueError(msg)


def jacobi_iteration_plain(p_cur, p_alt, u, w, pbc_code, not_wall8, dt: float, dx: float, *,
                           n_iters: int = 1, v_limit: float | None = None):
    """`n_iters` chained Jacobi iterations composed from the eager ops, as
    ``fluid2d_tpu/models/common.py:108-116`` chains
    ``jacobi_pressure_iteration``. Returns ``(p_cur, p_alt)``, plus the
    norm-limited ``(2, X, Y)`` velocity when `v_limit` is given."""
    _check_n_iters(n_iters)
    masks = _JacobiMasks(pbc_code, not_wall8)
    pair = (p_cur, p_alt)
    for _ in range(n_iters):
        pair = jacobi_pressure_iteration(*pair, u, w, masks, dt, dx)
    if v_limit is None:
        return pair
    return (*pair, limit_vector_norm(torch.stack([u, w]), v_limit))


def jacobi_iteration_cuda(p_cur, p_alt, u, w, pbc_code, not_wall8, dt: float, dx: float, *,
                          n_iters: int = 1, v_limit: float | None = None):
    """`n_iters` (1..4) Jacobi iterations (pressure BC, then the sweep of
    every not-wall cell) in one kernel run, with the velocity-norm limiter
    folded in when `v_limit` is given.

    CPU tensors take :func:`jacobi_iteration_plain`. CUDA tensors launch
    ``csrc/jacobi.cu``; anything the kernel does not take raises. Outputs
    are fresh tensors.
    """
    _check_n_iters(n_iters)
    if on_cpu(p_cur, "jacobi_iteration_cuda"):
        return jacobi_iteration_plain(p_cur, p_alt, u, w, pbc_code, not_wall8, dt, dx,
                                      n_iters=n_iters, v_limit=v_limit)
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
        require(not_wall8, "not_wall8", plane, i8, dev),
    ]
    p_out = torch.empty_like(p_cur)
    p_bc = torch.empty_like(p_cur)
    # The scratch pair holds the iterations of the other parity than the last.
    scratch = [torch.empty_like(p_cur) if n_iters > 1 else None for _ in range(2)]
    v_lim = None if v_limit is None else torch.empty((2, x_rows, y_cols), dtype=f32, device=dev)
    launch(
        "f2d_jacobi_iteration", dev,
        *ptrs, p_out.data_ptr(), p_bc.data_ptr(), *(_ptr(t) for t in scratch), _ptr(v_lim),
        x_rows, y_cols, n_iters, dx, recip32(8 * dt), 0.0 if v_limit is None else v_limit,
    )
    jacobi_iteration_cuda.launches += 1
    if v_lim is None:
        return p_out, p_bc
    return p_out, p_bc, v_lim


jacobi_iteration_cuda.launches = 0  # kernel runs (two __global__ launches per iteration each)
