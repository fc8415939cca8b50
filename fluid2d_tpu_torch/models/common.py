"""Shared pieces of the time-step model: the pressure solve with the
velocity limiter, vorticity confinement, and the kernel dispatch (port of
``fluid2d_tpu/models/common.py``).

Dispatch has no fallback: ``kernels="eager"`` runs the plain versions,
otherwise the wrappers run, which launch the CUDA kernels on CUDA tensors
and take the plain versions on CPU tensors; ``kernels="cuda"`` refuses
CPU tensors. A kernel that cannot run raises.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.config import SimConfig
from fluid2d_tpu_torch.ops.cuda_phases import confinement_cuda, confinement_plain
from fluid2d_tpu_torch.ops.cuda_stencil import (
    JACOBI_MAX_ITERS,
    jacobi_iteration_cuda,
    jacobi_iteration_plain,
    sor_iteration_cuda,
    sor_iteration_plain,
)
from fluid2d_tpu_torch.ops.limiters import limit_vector_norm
from fluid2d_tpu_torch.scenes.compile import Scene
from fluid2d_tpu_torch.utils.dtypes import f32

__all__ = ["use_kernels", "update_pressure_and_limit", "confinement"]


def use_kernels(cfg: SimConfig, t: torch.Tensor) -> bool:
    """Whether a phase goes through the kernel wrappers (False: the plain
    versions). ``kernels="cuda"`` with a non-CUDA tensor raises."""
    if cfg.kernels == "eager":
        return False
    if cfg.kernels == "cuda" and t.device.type != "cuda":
        msg = f'kernels="cuda" needs CUDA tensors; the state is on {t.device}'
        raise ValueError(msg)
    return True


def update_pressure_and_limit(p_cur, p_alt, v, scene: Scene, cfg: SimConfig):
    """``n_pressure_iter`` pressure iterations of the configured solver, all
    reading the same pre-limit v, then the velocity-norm limiter
    (``fs/solver.py:87-89``), which is folded into the final call.
    Returns ``(p_cur, p_alt, v_limited)``."""
    if cfg.n_pressure_iter <= 0:
        return p_cur, p_alt, limit_vector_norm(f32(v), cfg.velocity_limit).to(v.dtype)
    if cfg.pressure_solver == "jacobi":
        return _jacobi_iters(p_cur, p_alt, v, scene, cfg)
    sor = sor_iteration_cuda if use_kernels(cfg, p_cur) else sor_iteration_plain
    pair = (p_cur, p_alt)
    for _ in range(cfg.n_pressure_iter - 1):
        pair = sor(*pair, v[0], v[1], scene.pbc_code, scene.fluid8,
                   cfg.sor_omega, cfg.dt, cfg.dx)
    return sor(*pair, v[0], v[1], scene.pbc_code, scene.fluid8,
               cfg.sor_omega, cfg.dt, cfg.dx, v_limit=cfg.velocity_limit)


def _jacobi_iters(p_cur, p_alt, v, scene: Scene, cfg: SimConfig):
    """The Jacobi chain of ``fluid2d_tpu/models/common.py:150-180``: calls
    of at most four fused iterations, the remainder in the final call
    (6 → 4 + 2), which also applies the limiter."""
    jacobi = jacobi_iteration_cuda if use_kernels(cfg, p_cur) else jacobi_iteration_plain
    n = cfg.n_pressure_iter
    step = min(n, JACOBI_MAX_ITERS)
    pair = (p_cur, p_alt)
    while n > step:
        pair = jacobi(*pair, v[0], v[1], scene.pbc_code, scene.not_wall8, cfg.dt, cfg.dx,
                      n_iters=step)
        n -= step
    return jacobi(*pair, v[0], v[1], scene.pbc_code, scene.not_wall8, cfg.dt, cfg.dx,
                  n_iters=n, v_limit=cfg.velocity_limit)


def confinement(v_cur, v_alt, scene: Scene, cfg: SimConfig):
    """Vorticity confinement + swap (``fs/solver.py:84-86``)."""
    conf = confinement_cuda if use_kernels(cfg, v_cur) else confinement_plain
    return conf(v_cur, v_alt, scene.fluid8, cfg.dt, cfg.vor_eps, cfg.dx)
