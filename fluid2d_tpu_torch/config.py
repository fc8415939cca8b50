"""Simulation configuration (PyTorch port of ``fluid2d_tpu/config.py``).

The same frozen, hashable config with the same defaults. What differs:

* ``kernels`` selects between the hand-written CUDA kernels and their
  plain PyTorch versions: ``"auto"`` uses the kernels for CUDA tensors and
  the plain versions for CPU tensors, ``"cuda"`` requires CUDA tensors,
  ``"eager"`` runs the plain versions everywhere (the comparison path).
* All three schemes (``upwind``, ``kk``, ``cip``), both pressure solvers
  (``sor``, ``jacobi``) and both transport dtypes (``float32``,
  ``bfloat16``: the state stored in bf16, all arithmetic float32) are
  ported; any other dtype is refused with the JAX package's message.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SimConfig", "default_dt", "resolve_device", "VELOCITY_LIMIT", "KERNEL_MODES"]

VELOCITY_LIMIT = 10.0  # fs/solver.py:12
KERNEL_MODES = ("auto", "cuda", "eager")


def resolve_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; raises for CUDA when no card is there
    (nothing falls back to the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        msg = "no CUDA card: torch.cuda.is_available() is false (use --device cpu to check " \
              "the harness on the CPU)"
        raise RuntimeError(msg)
    return dev


def default_dt(resolution: int) -> float:
    """dt = 0.05 / resolution when unset (``main.py:56``); dx = 1/res, so
    dt/dx = 0.05."""
    return 0.05 / resolution


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters."""

    resolution: int = 400
    dt: float = 0.000125
    dx: float = 0.0025
    re: float = 1_000_000.0
    scheme: str = "cip"
    vor_eps: float | None = 5.0  # None disables vorticity confinement
    enable_dye: bool = True
    pressure_solver: str = "sor"
    sor_omega: float = 1.3
    n_pressure_iter: int = 2
    velocity_limit: float = VELOCITY_LIMIT
    kernels: str = "auto"  # "auto" | "cuda" | "eager"
    dtype: str = "float32"

    @staticmethod
    def create(
        resolution: int = 400,
        dt: float | None = None,
        re: float = 1_000_000.0,
        scheme: str = "cip",
        vor_eps: float | None = 5.0,
        enable_dye: bool = True,
        pressure_solver: str = "sor",
        sor_omega: float = 1.3,
        n_pressure_iter: int = 2,
        velocity_limit: float = VELOCITY_LIMIT,
        kernels: str = "auto",
        dtype: str = "float32",
    ) -> "SimConfig":
        """Mirror of the reference CLI's derived parameters
        (``main.py:56,63``): dt defaults to 0.05/res, dx = 1/res,
        vor_eps=0.0 is treated as disabled (``main.py:60-62``)."""
        if scheme not in ("upwind", "kk", "cip"):
            msg = f"Unknown scheme: {scheme}"
            raise ValueError(msg)
        if pressure_solver not in ("sor", "jacobi"):
            msg = f"Unknown pressure solver: {pressure_solver}"
            raise ValueError(msg)
        if dtype not in ("float32", "bfloat16"):
            msg = f"Unknown transport dtype: {dtype}"
            raise ValueError(msg)
        if kernels not in KERNEL_MODES:
            msg = f"Unknown kernels mode: {kernels} (valid: {', '.join(KERNEL_MODES)})"
            raise ValueError(msg)
        if vor_eps is not None and vor_eps == 0.0:
            vor_eps = None
        return SimConfig(
            resolution=resolution,
            dt=dt if dt else default_dt(resolution),
            dx=1.0 / resolution,
            re=re,
            scheme=scheme,
            vor_eps=vor_eps,
            enable_dye=enable_dye,
            pressure_solver=pressure_solver,
            sor_omega=sor_omega,
            n_pressure_iter=n_pressure_iter,
            velocity_limit=velocity_limit,
            kernels=kernels,
            dtype=dtype,
        )
