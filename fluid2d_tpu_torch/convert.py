"""Carry scenes and states between the JAX package and the port.

Both packages use the same field names and the same ``(C, X, Y)`` layout,
so a dict of NumPy arrays keyed by those names is the exchange format: a
state built by the JAX package (every alternate buffer and CIP gradient
plane included) runs unchanged in the port and comes back for comparison.
This module imports no JAX; the caller turns JAX arrays into NumPy.

NumPy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf crosses as
float32: widened by the caller or by :func:`state_to_numpy` (exact), and
narrowed on the way in by the ``dtype`` of :func:`state_from_numpy` /
:func:`scene_from_numpy` (exact for values that are bf16 already).
"""

from __future__ import annotations

import numpy as np
import torch

from fluid2d_tpu_torch.scenes.compile import Scene
from fluid2d_tpu_torch.state import SimState
from fluid2d_tpu_torch.utils.trace import to_host

__all__ = ["scene_from_numpy", "state_from_numpy", "state_to_numpy"]


def _tensor(a: np.ndarray, device: torch.device | str,
            dtype: torch.dtype | str | None = None) -> torch.Tensor:
    # A C-ordered copy: the input may be a read-only view of a JAX array.
    t = torch.from_numpy(np.array(a, order="C"))
    if dtype is not None and t.is_floating_point():
        t = t.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    return t.to(device)


def scene_from_numpy(arrays: dict[str, np.ndarray], device: torch.device | str,
                     dtype: torch.dtype | str | None = None) -> Scene:
    """A ``Scene`` on `device` from a dict holding every ``Scene`` field;
    the float leaves (``bc_const``, ``bc_dye``) cast to `dtype` when given."""
    missing = [name for name in Scene._fields if name not in arrays]
    if missing:
        msg = f"scene arrays lack {missing}"
        raise KeyError(msg)
    return Scene(**{name: _tensor(arrays[name], device, dtype) for name in Scene._fields})


def state_from_numpy(arrays: dict[str, np.ndarray], device: torch.device | str,
                     dtype: torch.dtype | str | None = None) -> SimState:
    """A ``SimState`` on `device`. Required: ``step, v, v_alt, p, p_alt``;
    optional leaves absent from `arrays` stay ``None``. The step counter is
    int32; the float leaves keep their dtype, or are cast to `dtype` when
    given (the transport dtype)."""
    unknown = set(arrays) - set(SimState._fields)
    if unknown:
        msg = f"not SimState fields: {sorted(unknown)}"
        raise KeyError(msg)
    kw = {name: _tensor(np.asarray(a), device, dtype) for name, a in arrays.items()}
    kw["step"] = kw["step"].to(torch.int32)
    return SimState(**kw)


def state_to_numpy(state: SimState) -> dict[str, np.ndarray]:
    """Every non-``None`` leaf of `state` as a host NumPy array; bf16
    leaves widened to float32 (exactly)."""
    return {
        name: to_host(leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
        for name, leaf in zip(SimState._fields, state)
        if leaf is not None
    }
