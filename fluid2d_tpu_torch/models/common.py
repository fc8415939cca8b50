"""Shared pieces of the time-step model: the pressure solve with the
velocity limiter, vorticity confinement, and the kernel dispatch (port of
``fluid2d_tpu/models/common.py``).

Dispatch has no fallback: ``kernels="eager"`` runs the plain versions,
otherwise the wrappers run, which launch the CUDA kernels on CUDA tensors
and take the plain versions on CPU tensors; ``kernels="cuda"`` refuses
CPU tensors. A kernel that cannot run raises.

A step's phases take an optional ``out``, a mapping from a phase's name to
the tensors it writes (``models/replay.py`` plans them; a CUDA graph of the
step replays into them). Without it every output is a fresh tensor.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.config import SimConfig
from fluid2d_tpu_torch.ops.cuda_phases import confinement_cuda, confinement_plain
from fluid2d_tpu_torch.ops.cuda_stencil import (
    JACOBI_MAX_ITERS,
    SOR_MAX_ITERS,
    jacobi_iteration_cuda,
    jacobi_iteration_plain,
    sor_iteration_cuda,
    sor_iteration_plain,
)
from fluid2d_tpu_torch.ops.limiters import limit_vector_norm
from fluid2d_tpu_torch.scenes.compile import Scene
from fluid2d_tpu_torch.utils.dtypes import f32, to_transport

__all__ = ["use_kernels", "out_kw", "pressure_chain", "update_pressure_and_limit", "confinement"]


def use_kernels(cfg: SimConfig, t: torch.Tensor) -> bool:
    """Whether a phase goes through the kernel wrappers (False: the plain
    versions). ``kernels="cuda"`` with a non-CUDA tensor raises."""
    if cfg.kernels == "eager":
        return False
    if cfg.kernels == "cuda" and t.device.type != "cuda":
        msg = f'kernels="cuda" needs CUDA tensors; the state is on {t.device}'
        raise ValueError(msg)
    return True


def out_kw(out, name: str) -> dict:
    """The keyword that hands phase `name` its planned outputs: ``{}``
    without a plan (fresh outputs; the plain versions take none)."""
    return {} if out is None else {"out": out[name]}


def pressure_chain(cfg: SimConfig) -> list[int]:
    """The iterations of each call of one step's pressure chain: the greedy
    chain of ``fluid2d_tpu/models/common.py:150-220``, calls of the most
    iterations one call runs (SOR 2, Jacobi 4) while more remain, then the
    rest (SOR 3 → [2, 1], 4 → [2, 2]; Jacobi 6 → [4, 2]); [] for none."""
    most = JACOBI_MAX_ITERS if cfg.pressure_solver == "jacobi" else SOR_MAX_ITERS
    n = max(cfg.n_pressure_iter, 0)
    step = min(n, most)
    calls = []
    while n > step:
        calls.append(step)
        n -= step
    return [*calls, n] if n else calls


def update_pressure_and_limit(p_cur, p_alt, v, scene: Scene, cfg: SimConfig, out=None):
    """``n_pressure_iter`` pressure iterations of the configured solver, all
    reading the same pre-limit v, then the velocity-norm limiter
    (``fs/solver.py:87-89``), which is folded into the final call.
    Returns ``(p_cur, p_alt, v_limited)``.

    The calls are :func:`pressure_chain`'s. As in
    ``fluid2d_tpu/models/common.py:98-119,146``, the chain runs in float32
    and rounds to the transport dtype once: the first call reads the
    state's pair, every call but the last returns a float32 pair, the last
    returns the pair and the limited velocity in the transport dtype. Call
    k of the chain writes ``out["pressure.<k>"]`` when `out` is given."""
    chain = pressure_chain(cfg)
    if not chain:
        return p_cur, p_alt, to_transport(limit_vector_norm(f32(v), cfg.velocity_limit), v.dtype)
    kernels = use_kernels(cfg, p_cur)
    if cfg.pressure_solver == "jacobi":
        solve = jacobi_iteration_cuda if kernels else jacobi_iteration_plain
        args = (scene.pbc_code, scene.not_wall8, cfg.dt, cfg.dx)
    else:
        solve = sor_iteration_cuda if kernels else sor_iteration_plain
        args = (scene.pbc_code, scene.fluid8, cfg.sor_omega, cfg.dt, cfg.dx)
    *head, last = chain
    pair = (p_cur, p_alt)
    for k, n in enumerate(head):
        pair = solve(*pair, v[0], v[1], *args, n_iters=n, out_dtype=torch.float32,
                     **out_kw(out, f"pressure.{k}"))
    return solve(*pair, v[0], v[1], *args, n_iters=last, v_limit=cfg.velocity_limit,
                 out_dtype=p_cur.dtype, **out_kw(out, f"pressure.{len(head)}"))


def confinement(v_cur, v_alt, scene: Scene, cfg: SimConfig, out=None):
    """Vorticity confinement + swap (``fs/solver.py:84-86``)."""
    conf = confinement_cuda if use_kernels(cfg, v_cur) else confinement_plain
    return conf(v_cur, v_alt, scene.fluid8, cfg.dt, cfg.vor_eps, cfg.dx,
                **out_kw(out, "confinement"))
