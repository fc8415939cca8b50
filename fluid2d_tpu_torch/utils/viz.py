"""Field → RGB visualizations (port of ``fluid2d_tpu/utils/viz.py``).

The reference's colormaps and the scale factors and wall colour of its
render kernels (``fs/visualization.py``, ``fs/fluid_simulator.py:16-17,
38-58,121-126``), as plain PyTorch ops on the state's device: a frame is
computed where the state lives as (X, Y, 3) float32. :func:`to_image` makes
it the 8-bit image for PNG or GIF writing (:mod:`.io`) or the viewer: on
the card for a CUDA frame (the kernel V1), so that only the image, X·Y·3
bytes, crosses to the host; in NumPy for a host frame.

NaN policy: the views use ``torch.maximum``, which propagates NaN as
``jnp.maximum`` does, so a NaN cell shows in the frame. (The kernels'
``fmin``/``fmax`` rule, which drops NaN, does not apply here.) In the 8-bit
image a NaN value reads 0 on both of :func:`to_image`'s paths.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fluid2d_tpu_torch.ops.cuda_view import to_image_cuda
from fluid2d_tpu_torch.ops.stencil import diff_x, diff_y
from fluid2d_tpu_torch.utils.trace import span, to_host

__all__ = [
    "WALL_COLOR",
    "visualize_norm",
    "visualize_pressure",
    "visualize_vorticity",
    "visualize_xy",
    "visualize_hue",
    "render_rgb",
    "to_image",
    "VIS_MODES",
]

WALL_COLOR = (0.5, 0.7, 0.5)  # fs/fluid_simulator.py:17


def _stack3(r, g, b):
    return torch.stack([r, g, b], dim=-1)


def _pos(x):
    """max(x, 0), NaN kept (``jnp.maximum(x, 0.0)``)."""
    return torch.maximum(x, torch.zeros_like(x))


def visualize_norm(v):
    """Grayscale ‖v‖ (``fs/visualization.py:9-11``); v is (2, X, Y) →
    (X, Y, 3)."""
    c = torch.sqrt(v[0] ** 2 + v[1] ** 2)
    return _stack3(c, c, c)


def visualize_pressure(p):
    """Red = +p, blue = −p (``fs/visualization.py:15-16``)."""
    return _stack3(_pos(p), torch.zeros_like(p), _pos(-p))


def visualize_vorticity(v, dx: float):
    """Red/blue curl (``fs/visualization.py:20-22``)."""
    curl = diff_x(v[1], dx) - diff_y(v[0], dx)
    return _stack3(_pos(curl), torch.zeros_like(curl), _pos(-curl))


def visualize_xy(v):
    """(y, 0, x) channel map (``fs/visualization.py:55-56``; unused by the
    reference CLI, kept for library parity)."""
    return _stack3(v[1], torch.zeros_like(v[0]), v[0])


def visualize_hue(v):
    """Direction→hue, log-banded magnitude→saturation/value
    (``fs/visualization.py:26-51``; unused by the reference CLI, kept for
    library parity). v is (2, X, Y) → (X, Y, 3)."""
    h = torch.atan2(v[1], v[0])
    h = torch.where(h < 0, h + 2 * math.pi, h) / (2 * math.pi)

    m = torch.sqrt(v[0] ** 2 + v[1] ** 2)
    # The reference expands the band [ranges, rangee) by factors of e until
    # it contains m (:37-39); closed form: n = ceil(ln(m/10)) clamped to ≥0.
    zero = torch.zeros_like(m)
    n = torch.where(m > 10.0, torch.ceil(torch.log(m / 10.0)), zero)
    rangee = 10.0 * torch.exp(n)
    ranges = torch.where(n == 0.0, zero, 10.0 * torch.exp(n - 1.0))
    k = (m - ranges) / (rangee - ranges)

    tri = torch.where(k < 0.5, k * 2.0, 1.0 - (k - 0.5) * 2.0)
    s = 1.0 - (1.0 - tri) ** 3
    s = 0.4 + s * 0.6
    val = 1.0 - tri
    val = 1.0 - (1.0 - val) ** 3
    val = 0.6 + val * 0.4
    return _hsv_to_rgb(h, s, val)


def _hsv_to_rgb(h, s, v):
    """Branch-free HSV→RGB (parity: ``fs/visualization.py:60-97``); a
    sector outside 0..5 gives 1, as ``jnp.select``'s default does."""
    h = torch.where(h == 1.0, torch.zeros_like(h), h)
    z = torch.floor(h * 6.0)
    i = z.to(torch.int32)
    f = h * 6.0 - z
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def sel(*arms):
        out = torch.ones_like(v)
        for k in reversed(range(6)):  # the first true condition wins, as in jnp.select
            out = torch.where(i == k, arms[k], out)
        return out

    return _stack3(sel(v, q, p, p, t, v), sel(t, v, v, q, p, p), sel(p, p, t, v, v, q))


VIS_MODES = ("norm", "pressure", "vorticity", "dye")


def render_rgb(state, scene, cfg, vis: int | str = 0):
    """Frame render on the state's device matching
    ``fs/fluid_simulator.py:38-58,121-126``: vis 0 = 0.2·norm +
    0.002·pressure, 1 = 0.04·pressure, 2 = 0.005·vorticity, 3 = raw dye;
    walls painted (0.5, 0.7, 0.5). Returns (X, Y, 3) float32."""
    if isinstance(vis, str):
        vis = VIS_MODES.index(vis)
    # Render in f32 whatever the transport dtype (one upcast per frame).
    v, p = state.v.float(), state.p.float()
    if vis == 0:
        rgb = 0.2 * visualize_norm(v) + 0.002 * visualize_pressure(p)
    elif vis == 1:
        rgb = 0.04 * visualize_pressure(p)
    elif vis == 2:
        rgb = 0.005 * visualize_vorticity(v, cfg.dx)
    elif vis == 3:
        if state.dye is None:
            msg = "dye visualization requires enable_dye=True"
            raise ValueError(msg)
        rgb = torch.movedim(state.dye.float(), 0, -1)
    else:
        msg = f"Unknown visualization mode: {vis}"
        raise ValueError(msg)
    wall = torch.tensor(WALL_COLOR, dtype=torch.float32, device=rgb.device)
    return torch.where(scene.wall[..., None], wall, rgb)


def to_image(rgb) -> np.ndarray:
    """(X, Y, 3) float frame (a tensor on any device, or an array) → uint8
    H×W×3 image in screen orientation (y up → row 0 at top, x to the
    right), a fresh array the caller owns.

    A CUDA tensor is converted on the card (``ops/cuda_view.py``, the
    kernel V1; a frame of another dtype is cast to float32 first), in the
    span ``f2d.to_image.convert``, which enqueues it; then the uint8 image,
    a quarter of the frame's bytes, is copied to the host in
    ``f2d.to_image.d2h`` (the wait for the queue and the copy). An array or
    a CPU tensor is converted in NumPy: ``f2d.to_image.d2h`` takes it as an
    array, ``f2d.to_image.convert`` clips, flips, scales and casts. Both
    give the same bits."""
    if isinstance(rgb, torch.Tensor) and rgb.device.type == "cuda":
        with span("f2d.to_image.convert"):
            img = to_image_cuda(rgb.float().contiguous())
        with span("f2d.to_image.d2h"):
            # Into fresh pageable memory: on an H100 at 3200×1600 faster than
            # a copy into a pinned buffer and one out of it (PERF.md, V1).
            return to_host(img).numpy()
    with span("f2d.to_image.d2h"):
        arr = to_host(rgb).numpy() if isinstance(rgb, torch.Tensor) else np.asarray(rgb)
    with span("f2d.to_image.convert"):
        arr = np.clip(arr, 0.0, 1.0)
        arr = np.flip(arr.transpose(1, 0, 2), axis=0)  # (Y, X, 3), top row = max y
        return (arr * 255.0 + 0.5).astype(np.uint8)
