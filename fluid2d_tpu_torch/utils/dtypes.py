"""Transport-dtype helpers (port of ``fluid2d_tpu/utils/dtypes.py``).

``SimConfig.dtype`` is the transport (device-memory storage) dtype of the
state fields; all arithmetic is float32 regardless. Every compute path
rounds at the same points: upcast on load (:func:`f32`), round once at
each phase output (:func:`to_transport`). The CUDA kernels widen on load
and round at their stores at the same points (``csrc/common.cuh``).
"""

from __future__ import annotations

import torch

__all__ = ["f32", "to_transport"]

_REDUCED = (torch.bfloat16, torch.float16)


def f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast a reduced-precision tensor to float32 for arithmetic
    (identity for float32 and integer tensors)."""
    return x.float() if x.dtype in _REDUCED else x


def to_transport(x: torch.Tensor, dtype: torch.dtype | str) -> torch.Tensor:
    """Round a computed (float32) tensor to the transport dtype, given as a
    torch dtype or its name (identity when they already match)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return x if x.dtype == dt else x.to(dt)
