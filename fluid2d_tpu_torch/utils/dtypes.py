"""Transport-dtype helper (port of ``fluid2d_tpu/utils/dtypes.py``).

All arithmetic is float32. The port stores float32 state only for now;
:func:`f32` marks the points where a reduced-precision transport dtype
would be widened on load, so that bf16 transport can slot in later.
"""

from __future__ import annotations

import torch

__all__ = ["f32"]

_REDUCED = (torch.bfloat16, torch.float16)


def f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast a reduced-precision tensor to float32 for arithmetic
    (identity for float32 and integer tensors)."""
    return x.float() if x.dtype in _REDUCED else x
