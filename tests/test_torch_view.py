"""The view's 8-bit image (``ops/cuda_view.py``, the kernel V1 in
``csrc/view.cu``) on the CPU.

``to_image_plain``, the kernel's arithmetic in PyTorch, against the NumPy
path of ``utils/viz.py:to_image`` (what a host frame takes) bit for bit: on
edge values (0, −0.0, 1, values whose ·255 + 0.5 lands on an integer or one
ulp beside it, values past [0, 1], ±inf, NaN, which reads 0) and on random
frames at ragged shapes. ``to_image_cuda`` takes a CPU tensor to the plain
version and raises for another device, dtype or shape. The kernel's tiling
rule (its tile, its vector and masked paths, the flip) replayed in NumPy
index for index writes every byte of the image once, bit-equal to the
NumPy path, and its vector path's loads and stores are aligned. The kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch.ops.cuda_view import to_image_cuda, to_image_plain
from fluid2d_tpu_torch.utils import viz

torch.set_num_threads(1)

SHAPES = [(1, 1), (3, 5), (63, 65), (65, 129)]


def _numpy_path(frame: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore"):  # NumPy's cast of NaN warns (and gives 0)
        return viz.to_image(frame)


def _edge_values() -> np.ndarray:
    """0, −0.0, 1, the float32 values nearest (n − 0.5)/255 and one and two
    ulps beside them for every n (·255 + 0.5 on, just under and just over
    the integer n), values past [0, 1], the smallest subnormal, ±inf, NaN."""
    f32 = np.float32
    near = np.array([(n - 0.5) / 255.0 for n in range(257)], dtype=f32)
    steps = [near]
    for direction in (np.inf, -np.inf):
        x = near
        for _ in range(2):
            x = np.nextafter(x, f32(direction))
            steps.append(x)
    special = np.array([0.0, -0.0, 1.0, np.nextafter(f32(1), f32(2)),
                        np.nextafter(f32(0), f32(-1)), np.nextafter(f32(0), f32(1)), 2.0, -1.0,
                        1e30, -1e30, np.inf, -np.inf, np.nan], dtype=f32)
    return np.concatenate([*steps, special])


def edge_frame() -> np.ndarray:
    """The edge values laid out as an (X, 7, 3) frame, padded with 0.5."""
    vals = _edge_values()
    cells = -(-vals.size // 21) * 21
    return np.concatenate([vals, np.full(cells - vals.size, 0.5, np.float32)]).reshape(-1, 7, 3)


def test_edge_values_land_on_both_sides_of_the_rounding():
    """The edge values do reach each side of each rounding step: in float32,
    ·255 + 0.5 lands exactly on integers and just under them."""
    x = _edge_values()
    x = x[np.isfinite(x) & (x >= 0) & (x <= 1)]
    y = x * np.float32(255.0) + np.float32(0.5)
    assert (y == np.floor(y)).sum() >= 200 and ((y - np.floor(y)) > 0.99).sum() >= 200


def test_plain_matches_numpy_on_edge_values():
    frame = edge_frame()
    got = to_image_plain(torch.from_numpy(frame)).numpy()
    ref = _numpy_path(frame)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    # the NaN value reads 0; ±inf read 255 and 0
    pixel = {float(v): got[frame.shape[1] - 1 - j, i, k]
             for (i, j, k), v in np.ndenumerate(frame) if not np.isfinite(v)}
    nan = [p for v, p in pixel.items() if np.isnan(v)]
    assert nan == [0] and pixel[np.inf] == 255 and pixel[-np.inf] == 0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_matches_numpy_on_random_frames(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    frame = rng.uniform(-0.2, 1.2, (*shape, 3)).astype(np.float32)
    got = to_image_plain(torch.from_numpy(frame))
    assert got.is_contiguous() and tuple(got.shape) == (shape[1], shape[0], 3)
    np.testing.assert_array_equal(got.numpy(), _numpy_path(frame))


def test_cuda_wrapper_takes_the_plain_version_on_the_cpu():
    frame = torch.from_numpy(edge_frame())
    got = to_image_cuda(frame)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    assert torch.equal(got, to_image_plain(frame))


@pytest.mark.parametrize(("frame", "error"), [
    (torch.zeros((4, 5, 3), device="meta"), ValueError),
    (torch.zeros((4, 5, 3), dtype=torch.float64), TypeError),
    (torch.zeros((4, 5, 3), dtype=torch.bfloat16), TypeError),
    (torch.zeros((4, 5)), ValueError),
    (torch.zeros((4, 5, 4)), ValueError),
    (torch.zeros((4, 5, 3, 1)), ValueError),
    (torch.zeros((0, 5, 3)), ValueError),
], ids=["meta", "float64", "bfloat16", "2d", "4_channels", "4d", "empty"])
def test_cuda_wrapper_raises(frame, error):
    with pytest.raises(error):
        to_image_cuda(frame)


# --- the kernel's tiling rule, replayed -------------------------------------------

def _kernel_constants() -> dict[str, int]:
    src = (Path(__file__).resolve().parent.parent / "fluid2d_tpu_torch" / "csrc" /
           "view.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kTileX", "kTileY", "kThreads")}


def _to_u8(x: np.ndarray) -> np.ndarray:
    c = np.fmin(np.fmax(x, np.float32(0)), np.float32(1))
    return (c * np.float32(255) + np.float32(0.5)).astype(np.uint8)


def _replay(frame: np.ndarray, aligned: bool) -> np.ndarray:
    """``to_image_kernel``'s blocks, index for index: every byte each writes
    to shared memory and to the image. Fails on a byte written twice, a
    staged byte read before it is written or an unaligned vector access; -1
    marks a byte of the image never written."""
    k = _kernel_constants()
    tx, ty = k["kTileX"], k["kTileY"]
    row_bytes, pitch, row_floats = tx * 3, tx * 3 + 4, ty * 3
    vecs, words = row_floats // 4, row_bytes // 4
    n_x, n_y = frame.shape[:2]
    src_all, img = frame.ravel(), np.full(n_y * n_x * 3, -1, np.int16)
    vec = aligned and n_x % 4 == 0 and n_y % 4 == 0
    for bx in range(-(-n_x // tx)):
        for by in range(-(-n_y // ty)):
            x0, y0 = bx * tx, by * ty
            nx, ny = min(tx, n_x - x0), min(ty, n_y - y0)
            src, dst = (x0 * n_y + y0) * 3, ((n_y - 1 - y0) * n_x + x0) * 3
            tile = np.full(ty * pitch, -1, np.int16)
            if vec:  # nx, ny multiples of 4: whole float4s and words, masked at the edge
                assert nx % 4 == 0 and ny % 4 == 0
                v = np.arange(tx * vecs)
                assert v.size % k["kThreads"] == 0
                xl, q = v // vecs, v % vecs
                keep = (xl < nx) & (q < ny * 3 // 4)
                xl, p = xl[keep], 4 * q[keep]
                base = src + xl * n_y * 3 + p
                assert (base % 4 == 0).all()  # float4 loads
                for i in range(4):
                    at = ((p + i) // 3) * pitch + xl * 3 + (p + i) % 3
                    assert (tile[at] == -1).all()
                    tile[at] = _to_u8(src_all[base + i])
                v = np.arange(ty * words)
                assert v.size % k["kThreads"] == 0
                yl, w = v // words, v % words
                keep = (yl < ny) & (w < nx * 3 // 4)
                yl, w = yl[keep], w[keep]
                out_word = dst - yl * n_x * 3 + 4 * w
                assert (out_word % 4 == 0).all() and ((yl * pitch) % 4 == 0).all()
                for b in range(4):
                    staged = tile[yl * pitch + 4 * w + b]
                    assert (img[out_word + b] == -1).all() and (staged >= 0).all()
                    img[out_word + b] = staged
            else:
                v = np.arange(tx * row_floats)
                xl, p = v // row_floats, v % row_floats
                keep = (xl < nx) & (p < ny * 3)
                xl, p = xl[keep], p[keep]
                at = (p // 3) * pitch + xl * 3 + p % 3
                assert (tile[at] == -1).all() and np.unique(at).size == at.size
                tile[at] = _to_u8(src_all[src + xl * n_y * 3 + p])
                v = np.arange(ty * row_bytes)
                yl, b = v // row_bytes, v % row_bytes
                keep = (yl < ny) & (b < nx * 3)
                yl, b = yl[keep], b[keep]
                out = dst + b - yl * n_x * 3
                assert (img[out] == -1).all() and (tile[yl * pitch + b] >= 0).all()
                img[out] = tile[yl * pitch + b]
    return img.reshape(n_y, n_x, 3)


@pytest.mark.parametrize(("shape", "aligned"), [
    ((128, 128), True), ((128, 128), False), ((192, 64), True), ((800, 400), True),
    ((132, 68), True), ((130, 128), True), *((s, True) for s in SHAPES),
], ids=["128x128", "128x128_offset", "192x64", "800x400", "132x68", "130x128",
        *(f"{s[0]}x{s[1]}" for s in SHAPES)])
def test_kernel_tiling_rule_replayed(shape, aligned):
    """The vector path (aligned, X and Y multiples of 4) on whole tiles and
    on a ragged edge of either axis, the scalar path on an unaligned frame,
    on X not a multiple of 4 and on the shapes above: every byte written
    once, bit-equal to the NumPy path."""
    rng = np.random.default_rng(shape[0] + 7 * shape[1])
    frame = rng.uniform(-0.2, 1.2, (*shape, 3)).astype(np.float32)
    frame.ravel()[:: 97] = np.nan
    img = _replay(frame, aligned)
    assert (img >= 0).all()
    np.testing.assert_array_equal(img.astype(np.uint8), _numpy_path(frame))
