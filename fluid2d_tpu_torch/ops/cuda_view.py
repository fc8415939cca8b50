"""The view's 8-bit image on the card (V1) and its plain PyTorch version.

``to_image_cuda`` (V1, ``csrc/view.cu`` says more)
  The (X, Y, 3) float32 frame of ``render`` to the (Y, X, 3) uint8 image in
  screen orientation, ``out[r, c, k] = in[c, Y-1-r, k]``: clipped to
  [0, 1], times 255, plus 0.5, truncated, each step rounded as NumPy rounds
  ``np.clip(arr, 0.0, 1.0) * 255.0 + 0.5`` in float32 before
  ``.astype(np.uint8)``, so the image is the one ``utils/viz.py:to_image``
  computes on the host, to the bit. A NaN value reads 0. Replaces no TPU
  kernel: the JAX package converts on the host. Bound: bytes, 15 a cell.

The wrapper takes a CPU tensor to the plain version and launches the kernel
on a CUDA tensor; there is no other path. ``ops/launch.py:launch`` counts
its runs (``utils/trace.py:launches["f2d_to_image"]``).
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.launch import launch, on_cpu, require

__all__ = ["to_image_cuda", "to_image_plain"]


def _frame_shape(rgb: torch.Tensor) -> tuple[int, int]:
    """(X, Y) of an (X, Y, 3) float32 frame; raises for any other."""
    if rgb.dtype != torch.float32:
        msg = f"to_image_cuda: frame of {rgb.dtype}, expected torch.float32"
        raise TypeError(msg)
    if rgb.dim() != 3 or rgb.shape[2] != 3 or rgb.shape[0] < 1 or rgb.shape[1] < 1:
        msg = f"to_image_cuda: frame of shape {tuple(rgb.shape)}, expected (X, Y, 3)"
        raise ValueError(msg)
    return rgb.shape[0], rgb.shape[1]


def to_image_plain(rgb: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: ``fmin(fmax(x, 0), 1)`` (a NaN
    becomes 0, as ``fmaxf`` makes it), ``· 255``, ``+ 0.5``, y flipped and
    moved first, truncated to uint8."""
    c = torch.fmin(torch.fmax(rgb, rgb.new_zeros(())), rgb.new_ones(()))
    scaled = c * 255.0 + 0.5
    return torch.flip(scaled.transpose(0, 1), (0,)).to(torch.uint8).contiguous()


def to_image_cuda(rgb: torch.Tensor) -> torch.Tensor:
    """(X, Y, 3) float32 frame, contiguous → (Y, X, 3) uint8 image on the
    frame's device."""
    x_rows, y_cols = _frame_shape(rgb)
    if on_cpu(rgb, "to_image_cuda"):
        return to_image_plain(rgb)
    dev = rgb.device
    ptr = require(rgb, "rgb", (x_rows, y_cols, 3), torch.float32, dev)
    out = torch.empty((y_cols, x_rows, 3), dtype=torch.uint8, device=dev)
    launch("f2d_to_image", dev, ptr, out.data_ptr(), x_rows, y_cols)
    return out
