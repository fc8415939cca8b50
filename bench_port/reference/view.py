"""The reference's frame (``fs/fluid_simulator.py:38-58``, ``main.py:94-107``)
as plain PyTorch and NumPy: view 0, the reference's default, is 0.2·|v| in
grey plus 0.002·p in red (positive) and blue (negative), walls painted
(0.5, 0.7, 0.5). The frame goes to the host as an 8-bit image, y up."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["render", "to_image"]

WALL = (0.5, 0.7, 0.5)


def render(state: dict, wall, view: int):
    """(X, Y, 3) float32 frame of `view` from the state's ``v`` and ``p``."""
    if view != 0:
        msg = f"the reference draws view 0 only, not {view}"
        raise ValueError(msg)
    v, p = state["v"], state["p"]
    norm = torch.sqrt(v[0] ** 2 + v[1] ** 2)
    zero = torch.zeros_like(p)
    rgb = 0.2 * torch.stack([norm, norm, norm], dim=-1) + 0.002 * torch.stack(
        [torch.maximum(p, zero), zero, torch.maximum(-p, zero)], dim=-1)
    return torch.where(wall[..., None], torch.tensor(WALL, device=rgb.device), rgb)


def to_image(rgb) -> np.ndarray:
    """uint8 (Y, X, 3) image, row 0 at the top (largest y)."""
    arr = np.clip(rgb.cpu().numpy(), 0.0, 1.0)
    arr = np.flip(arr.transpose(1, 0, 2), axis=0)
    return (arr * 255.0 + 0.5).astype(np.uint8)
