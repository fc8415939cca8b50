"""The bf16 probes: the CUDA kernels and their plain PyTorch versions.

Source notes (``csrc/dtype_probes.cu`` says more beside each kernel).

``dtype_rate_cuda`` (C5a)
  Replaces ``scripts/vpu_dtype_probe.py`` (its Pallas kernel): chained
  arithmetic per element in float32 or in bf16, two bf16 lanes per
  instruction, in four op mixes (``RATE_MODES``). Bound: FFMA / HFMA2
  issue. A thread runs two independent chains of consecutive elements,
  interleaved step by step, in both dtypes (``csrc/dtype_probes.cu``
  ``kChains``); each element's chain is the same sequence of rounded
  instructions at any chain count. The plain version repeats every
  instruction in float64 and rounds its result to the element dtype, as the
  instruction does; it is exact up
  to a double rounding (float64 → float32 → bf16) where a bf16 result needs
  more than 24 bits, so the kernel is held to it within ``RATE_TOL_ULPS``
  units in the last place of each element. The constants make every step
  count: with ``|c1| < 1`` each step contracts the distance to a fixed point
  by about ``|c1|`` = 31/32 and flips its sign (``c3 < 0`` keeps the
  quadratic term of poly and cipmix contracting too), so from inputs in
  [2, 3) the chain is still far from that point after ``RATE_CHECK_PASSES``
  passes, and one step more or fewer moves every element by at least 4 units
  in the last place in both dtypes: a chain that skipped passes is caught.
  (With the script's c1 = 1.000001 and c2 = 1e-6, bf16 rounds c1 to 1 and c2
  below half a unit of 0.5: the chain is a fixed point, and a kernel that
  skipped every pass would pass any check.) At the timed depth the chains
  sit at the fixed point, finite.

``row_copy_cuda`` (C5b)
  Replaces ``scripts/bf16_dma_probe.py``: three row-window copies (tail,
  head, realign) of a float32 or bf16 plane through shared memory with
  16-byte ``cp.async`` copies; bit-equal to the plain slices. The head and
  realign copies shift rows within one window, one block; the tail copy
  takes one output row a block, stored as whole ``float4``s, so its rows
  move on many SMs at once (one block had stored every scalar from one SM,
  slower than ``out.copy_``).

Each wrapper takes CPU tensors to its plain version and launches its
kernel on CUDA tensors; there is no other path. ``ops/launch.py:launch``
counts kernel runs (``utils/trace.py:launches``).
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.launch import entry, launch, on_cpu, require

__all__ = [
    "RATE_MODES",
    "PASSES_PER_STEP",
    "RATE_CONSTS",
    "RATE_CHECK_PASSES",
    "RATE_TOL_ULPS",
    "COPY_MODES",
    "dtype_rate_cuda",
    "dtype_rate_plain",
    "ulps_apart",
    "row_copy_cuda",
    "row_copy_plain",
]

RATE_MODES = ("fma", "poly", "select", "cipmix")
PASSES_PER_STEP = {"fma": 1, "poly": 3, "select": 2, "cipmix": 4}  # instructions a step
RATE_CONSTS = (-0.96875, 0.5, -0.015625)  # c1 = -31/32, c2, c3: exact in bf16
RATE_CHECK_PASSES = 48  # a multiple of every mode's passes a step
RATE_TOL_ULPS = {torch.float32: 1.0, torch.bfloat16: 1.0}
COPY_MODES = ("tail", "head", "realign")
_MANTISSA = {torch.float32: 23, torch.bfloat16: 7}


def _steps(passes: int, mode: str) -> int:
    if mode not in PASSES_PER_STEP:
        msg = f"mode {mode!r}: one of {RATE_MODES}"
        raise ValueError(msg)
    per = PASSES_PER_STEP[mode]
    if passes < per or passes % per:
        msg = f"passes={passes}: a positive multiple of {per} for mode {mode!r}"
        raise ValueError(msg)
    return passes // per


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float64 result rounded as an instruction of `dtype` rounds it
    (kept in float64)."""
    y = x.to(torch.float32)
    if dtype == torch.bfloat16:
        y = y.to(torch.bfloat16)
    return y.to(torch.float64)


def dtype_rate_plain(x: torch.Tensor, passes: int, mode: str,
                     consts: tuple[float, float, float] = RATE_CONSTS) -> torch.Tensor:
    """The kernel's chains instruction by instruction: each computed in
    float64 and rounded to x's dtype. Returns x's dtype."""
    steps = _steps(passes, mode)
    c1, c2, c3 = consts
    dt = x.dtype
    a = x.to(torch.float64)

    def sel(v, c):
        return torch.where(v > 0, c, -c)

    for _ in range(steps):
        if mode == "fma":
            a = _round(a * c1 + c2, dt)
        elif mode == "poly":
            m = _round(a * a, dt)
            a = _round(m * c3 + _round(a * c1 + c2, dt), dt)
        elif mode == "select":
            a = _round(a * sel(a, c1) + c2, dt)
        else:
            m = _round(a * a, dt)
            a = _round(_round(m * sel(a, c3) + a, dt) * c1 + c2, dt)
    return a.to(dt)


def ulps_apart(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|got − ref| per element in units in the last place of ref's dtype
    at |ref| (float64)."""
    r = ref.to(torch.float64)
    exp = torch.floor(torch.log2(r.abs().clamp_min(2.0**-126)))
    return (got.to(torch.float64) - r).abs() / torch.exp2(exp - _MANTISSA[ref.dtype])


def dtype_rate_cuda(x: torch.Tensor, passes: int, mode: str) -> torch.Tensor:
    """`passes` instructions of mode `mode` per element of a contiguous
    float32 or bf16 tensor (bf16: an even number of elements, two a
    thread); returns the chains' ends in x's dtype."""
    steps = _steps(passes, mode)
    if on_cpu(x, "dtype_rate_cuda"):
        return dtype_rate_plain(x, passes, mode)
    dev, dt = x.device, x.dtype
    name = entry("f2d_dtype_rate", dt)
    ptr = require(x, "x", tuple(x.shape), dt, dev)
    n = x.numel()
    if dt == torch.bfloat16:
        if n % 2 or ptr % 4:
            msg = "dtype_rate_cuda: bf16 needs an even element count, 4-byte aligned (pairs)"
            raise ValueError(msg)
        n //= 2
    out = torch.empty_like(x)
    launch(name, dev, ptr, out.data_ptr(), n, steps, RATE_MODES.index(mode), *RATE_CONSTS)
    return out


def row_copy_plain(x: torch.Tensor, mode: str, t: int = 16) -> torch.Tensor:
    """The copy as slices: tail ``x[8:8+t]``; head ``win = x[:t+16]``,
    ``win[0:16] = win[8:24]``; realign ``win[8:] = win[:t+8]``; then rows
    [0, t) of the window, as float32."""
    if mode == "tail":
        return x[8:8 + t].to(torch.float32)
    win = x[:t + 16].clone()
    if mode == "head":
        win[0:16] = win[8:24].clone()
    elif mode == "realign":
        win[8:] = win[:t + 8].clone()
    else:
        msg = f"mode {mode!r}: one of {COPY_MODES}"
        raise ValueError(msg)
    return win[:t].to(torch.float32)


def row_copy_cuda(x: torch.Tensor, mode: str, t: int = 16) -> torch.Tensor:
    """One of the three row-window copies of a contiguous (rows, cols)
    float32 or bf16 plane; returns (t, cols) float32."""
    if mode not in COPY_MODES:
        msg = f"mode {mode!r}: one of {COPY_MODES}"
        raise ValueError(msg)
    if on_cpu(x, "row_copy_cuda"):
        return row_copy_plain(x, mode, t)
    dev, dt = x.device, x.dtype
    rows, cols = x.shape
    name = entry("f2d_row_copy", dt)
    ptr = require(x, "x", (rows, cols), dt, dev)
    row_bytes = cols * x.element_size()
    if ptr % 16 or row_bytes % 16:
        msg = "row_copy_cuda: cp.async needs 16-byte aligned rows (the base and cols·itemsize)"
        raise ValueError(msg)
    # (t + 16) rows in shared memory, of which head reads rows [8, 24); a
    # thread moves at most 32 elements.
    if (t < (8 if mode == "head" else 1) or rows < t + 16 or (t + 8) * cols > 32 * 256
            or (t + 16) * row_bytes > 48 * 1024):
        msg = f"row_copy_cuda: t={t}, cols={cols} outside the one-block window"
        raise ValueError(msg)
    out = torch.empty((t, cols), dtype=torch.float32, device=dev)
    launch(name, dev, ptr, out.data_ptr(), cols, t, COPY_MODES.index(mode))
    return out
