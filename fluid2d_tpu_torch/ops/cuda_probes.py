"""The probes: the CUDA kernels and their plain PyTorch versions.

Source notes (``csrc/probes.cu`` says more beside each kernel).

``copy_add1_cuda`` (C2)
  Replaces ``fluid2d_tpu/utils/profiling.py:measure_hbm_bandwidth`` (its
  Pallas copy kernel). ``o = x + 1``, one float4 per thread. Bound: device
  memory bytes, one read and one write per element.

``mix_twin_cuda`` (C3)
  Replaces ``profiling.py:measure_mix_ceiling``, ``measure_slide_ceiling``
  and ``measure_slide2d_ceiling``: the no-op twin of one kernel's operands.
  Reads every float32 and int8 input plane once, sums them in table order
  in float32, writes the sum to every output plane. Bound: bytes. Given a
  twin with bfloat16 planes it runs ``mix_twin_bf16_cuda``.

``mix_twin_bf16_cuda`` (C5c, the bf16 arm of C3)
  Replaces ``scripts/bf16_geometry_probe.py``: the same twin of a kernel at
  bf16 transport, with bfloat16 planes beside the float32 ones; a bfloat16
  output holds the sum rounded to nearest even. Its own kernel and its own
  count. Bound: bytes.

``fma_rate_cuda`` (C4)
  Replaces ``profiling.py:measure_vpu_throughput``: eight independent
  chains of ``a = fma(a, c1, c2)`` per element. Bound: FP32 FMA issue.
  Each FMA rounds once; the plain version's ``a * c1 + c2`` rounds twice,
  so the two agree only within a tolerance at a shallow depth. At full
  depth the kernel is held to the plain version in float64 within
  ``fma_rate_error_bound``, which one round more or less exceeds.

``fma_sweep_cuda`` (C5d)
  Replaces ``scripts/vpu_rate_sweep.py:49`` (its Pallas kernel): C4's
  chains with their count ``nchain`` ∈ {1, 4, 8} a template parameter and
  the block size (64, 256 or 1024 threads) a launch argument, so that a
  sweep over (block, chains, depth) finds the best FMA rate. Bound: FP32
  FMA issue. Held to the float64 plain version within
  ``fma_rate_error_bound(x, passes, nchain)``, as C4.

``geometry_twin_cuda`` (C5e, C5f)
  Replaces ``scripts/dma_geometry_sweep.py:232`` (``make_case``) and
  ``scripts/dma_geometry_bench.py:100, :205`` (``dyelike_call``,
  ``element_call``): the no-op twin of an operand geometry. Each input is
  read in full, with a halo reach h also at rows i ± h (clamped), summed in
  float32 in table order, and the sum is written to every output. Channels
  on the kernel's z axis: per-channel inputs and outputs are (C, X, Y), shared
  inputs (X, Y) planes that every channel reads. Bound: bytes; the bytes
  counted are each operand once (the compulsory traffic), so a halo that
  costs device-memory traffic shows as a lower rate than h = 0.

``row_window_cuda`` (C5g)
  Replaces ``scripts/dma_rowwin_1600_check.py:57``: every tile of t rows of
  an (X, Y) float32 plane fetches its (t + 2h)-row window into shared
  memory with one Hopper bulk copy a row, the edge tiles realign it there,
  and ``out = 2 · window[h : h + t]``, which is ``2 · a`` to the bit. The
  window must fit a block's 232,448 bytes of shared memory
  (``row_window_tile``). Bound: bytes.

``toy_elementwise_cuda`` (C6)
  Replaces ``tests/test_profiling.py:134`` (``x·2 + 1``) and ``:158``
  (``x/3``, ``x·3``): the el-op counter test's toy kernels. The division is
  ``x · recip32(3)``, as PyTorch's CUDA division by a Python scalar rounds
  it, so every op is bit-equal to its plain version on the card. The port's
  el-op counter (``utils/profiling.py:collect_elops``) counts the plain
  versions. Bound: bytes.

Each wrapper takes CPU tensors to its plain version and launches its
kernel on CUDA tensors; there is no other path. ``<wrapper>.launches``
counts kernel runs.
"""

from __future__ import annotations

import numpy as np
import torch

from fluid2d_tpu_torch.ops.launch import launch, on_cpu, operand_bytes, recip32, require

__all__ = [
    "FMA_CHAINS",
    "FMA_SWEEP_CHAINS",
    "GeometryOperands",
    "MixOperands",
    "ROW_WINDOW_SMEM",
    "TOY_OPS",
    "copy_add1_cuda",
    "copy_add1_plain",
    "mix_twin_bf16_cuda",
    "mix_twin_cuda",
    "mix_twin_plain",
    "fma_rate_cuda",
    "fma_rate_error_bound",
    "fma_rate_plain",
    "fma_sweep_cuda",
    "geometry_twin_cuda",
    "geometry_twin_plain",
    "row_window_cuda",
    "row_window_plain",
    "row_window_tile",
    "toy_elementwise_cuda",
    "toy_elementwise_plain",
]

FMA_CHAINS = 8  # C4's independent chains per element (csrc/probes.cu:kC4Chains)
FMA_SWEEP_CHAINS = (1, 4, 8)  # the chain counts C5d's kernel is built for
# The chains' constants, float32 values passed to the kernel as arguments so
# that the compiler cannot fold the chains. c2 moves each chain by ~1e-3 a
# round: far more than the rounding between the kernel and its plain
# versions (fma_rate_error_bound), so a kernel that skips a round fails.
_C1, _C2 = float(np.float32(1.000001)), float(np.float32(1e-3))


# --- C2: streaming copy -----------------------------------------------------------


def copy_add1_plain(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``x + 1``, into `out` when given."""
    return x + 1 if out is None else torch.add(x, 1, out=out)


def copy_add1_cuda(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``x + 1`` over a contiguous float32 tensor, into `out` (same shape)
    when given, else into a fresh tensor."""
    if on_cpu(x, "copy_add1_cuda"):
        return copy_add1_plain(x, out)
    dev = x.device
    shape = tuple(x.shape)
    if out is None:
        out = torch.empty_like(x)
    ptrs = [require(x, "x", shape, torch.float32, dev),
            require(out, "out", shape, torch.float32, dev)]
    if any(p % 16 for p in ptrs):
        msg = "copy_add1_cuda: x and out must be 16-byte aligned (float4 loads)"
        raise ValueError(msg)
    launch("f2d_copy_add1", dev, *ptrs, x.numel())
    copy_add1_cuda.launches += 1
    return out


copy_add1_cuda.launches = 0


# --- C3: mix twin -------------------------------------------------------------------


class MixOperands:
    """The planes of one mix twin, checked once: float32, bfloat16 and int8
    input planes, and fresh output planes (`n_out` float32, then `n_out16`
    bfloat16), all (X, Y) on one device; on a card also the device table of
    their pointers (int64, in that order) that the kernel reads. Build it
    once and launch it many times: the table costs a host→device copy."""

    def __init__(self, f32_in: list[torch.Tensor], i8_in: list[torch.Tensor], n_out: int,
                 bf16_in: list[torch.Tensor] = (), n_out16: int = 0):
        if not (f32_in or bf16_in) or n_out + n_out16 < 1:
            msg = "a mix twin needs at least one float input plane and one output plane"
            raise ValueError(msg)
        first = (list(f32_in) + list(bf16_in))[0]
        dev = first.device
        plane = tuple(first.shape)
        if len(plane) != 2:
            msg = f"mix twin planes are (X, Y), got {plane}"
            raise ValueError(msg)
        ptrs = [require(t, f"f32_in[{k}]", plane, torch.float32, dev)
                for k, t in enumerate(f32_in)]
        ptrs += [require(t, f"bf16_in[{k}]", plane, torch.bfloat16, dev)
                 for k, t in enumerate(bf16_in)]
        ptrs += [require(t, f"i8_in[{k}]", plane, torch.int8, dev) for k, t in enumerate(i8_in)]
        self.f32_in, self.bf16_in, self.i8_in = list(f32_in), list(bf16_in), list(i8_in)
        self.n_out32 = n_out
        self.outs = tuple(torch.empty(plane, dtype=torch.float32 if k < n_out else torch.bfloat16,
                                      device=dev)
                          for k in range(n_out + n_out16))
        ptrs += [o.data_ptr() for o in self.outs]
        self.device, self.plane = dev, plane
        self.table = (None if dev.type == "cpu"
                      else torch.tensor(ptrs, dtype=torch.int64).to(dev))


def mix_twin_plain(ops: MixOperands) -> tuple[torch.Tensor, ...]:
    """The sum of every input plane, float32, bfloat16 then int8, in order,
    in float32, written to one fresh plane per output (of its dtype)."""
    acc = torch.zeros(ops.plane, dtype=torch.float32, device=ops.device)
    for t in ops.f32_in:
        acc = acc + t
    for t in (*ops.bf16_in, *ops.i8_in):
        acc = acc + t.to(torch.float32)
    return tuple(acc.to(o.dtype, copy=True) for o in ops.outs)


def mix_twin_cuda(ops: MixOperands) -> tuple[torch.Tensor, ...]:
    """The mix twin over `ops`: on a card, the kernel writes the sum into
    ``ops.outs`` and returns them. A twin with bfloat16 planes goes to
    :func:`mix_twin_bf16_cuda`, which counts its own launches."""
    if ops.bf16_in or ops.n_out32 < len(ops.outs):
        return mix_twin_bf16_cuda(ops)
    if on_cpu(ops.f32_in[0], "mix_twin_cuda"):
        return mix_twin_plain(ops)
    launch("f2d_mix_twin", ops.device, ops.table.data_ptr(), len(ops.f32_in), len(ops.i8_in),
           len(ops.outs), ops.plane[0] * ops.plane[1])
    mix_twin_cuda.launches += 1
    return ops.outs


mix_twin_cuda.launches = 0


def mix_twin_bf16_cuda(ops: MixOperands) -> tuple[torch.Tensor, ...]:
    """The twin of a kernel at bf16 transport over `ops` (float32, bfloat16
    and int8 planes): on a card, the kernel writes the sum into ``ops.outs``
    and returns them."""
    if on_cpu((ops.f32_in + ops.bf16_in)[0], "mix_twin_bf16_cuda"):
        return mix_twin_plain(ops)
    n_out = len(ops.outs)
    launch("f2d_mix_twin_bf16", ops.device, ops.table.data_ptr(), len(ops.f32_in),
           len(ops.bf16_in), len(ops.i8_in), ops.n_out32, n_out - ops.n_out32,
           ops.plane[0] * ops.plane[1])
    mix_twin_bf16_cuda.launches += 1
    return ops.outs


mix_twin_bf16_cuda.launches = 0


# --- C4: FMA rate ---------------------------------------------------------------------


def _rounds(passes: int, nchain: int = FMA_CHAINS) -> int:
    if passes < nchain or passes % nchain:
        msg = f"passes={passes}: a positive multiple of {nchain}"
        raise ValueError(msg)
    return passes // nchain


def _chain_scale(c: int) -> float:
    """The float32 start multiplier of chain c, as the kernel rounds it."""
    return float(np.float32(1.0 + 1e-7 * c))


def fma_rate_plain(x: torch.Tensor, passes: int, nchain: int = FMA_CHAINS) -> torch.Tensor:
    """The same `nchain` chains as torch ops: ``a = a * c1 + c2`` (two
    roundings per step where the kernel's FMA takes one), then the chains'
    sum."""
    accs = [x * _chain_scale(c) for c in range(nchain)]
    for _ in range(_rounds(passes, nchain)):
        accs = [a * _C1 + _C2 for a in accs]
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc


def fma_rate_error_bound(x: torch.Tensor, passes: int, nchain: int = FMA_CHAINS) -> float:
    """A bound on |kernel(x, passes) - exact| at any element for `nchain`
    chains (C4: ``fma_rate_cuda``; C5d: ``fma_sweep_cuda``), where exact is
    the chains' sum in exact arithmetic (``fma_rate_plain`` on float64
    stands for it). Each step rounds once, by at most u = 2**-24 of its
    result: the start multiply, every FMA (an earlier error grows by c1 a
    round) and the nchain - 1 merge adds (partial sums below nchain·A). A
    bounds every chain value: c1**rounds·(|x|·s + rounds·c2), with s the
    largest start multiplier, plus 0.1% for the rounding itself."""
    rounds = _rounds(passes, nchain)
    grow = _C1**rounds
    a_max = grow * (float(x.abs().max()) * _chain_scale(nchain - 1) + rounds * _C2) * 1.001
    per_value = 2.0**-24 * a_max
    return per_value * (nchain * (rounds + 1) * grow + nchain * (nchain - 1))


def fma_rate_cuda(x: torch.Tensor, passes: int) -> torch.Tensor:
    """`passes` FMA element-passes per element of a contiguous float32
    tensor, split over FMA_CHAINS chains; returns the chains' sum."""
    rounds = _rounds(passes)
    if on_cpu(x, "fma_rate_cuda"):
        return fma_rate_plain(x, passes)
    dev = x.device
    ptr = require(x, "x", tuple(x.shape), torch.float32, dev)
    out = torch.empty_like(x)
    launch("f2d_fma_rate", dev, ptr, out.data_ptr(), x.numel(), rounds, _C1, _C2)
    fma_rate_cuda.launches += 1
    return out


fma_rate_cuda.launches = 0


# --- C5d: FMA-rate sweep --------------------------------------------------------------


def fma_sweep_cuda(x: torch.Tensor, passes: int, nchain: int, threads: int = 256) -> torch.Tensor:
    """`passes` FMA element-passes per element of a contiguous float32
    tensor, split over `nchain` ∈ FMA_SWEEP_CHAINS chains, `threads` threads
    a block (a multiple of 32, at most 1024); returns the chains' sum."""
    if nchain not in FMA_SWEEP_CHAINS:
        msg = f"nchain={nchain}: one of {FMA_SWEEP_CHAINS}"
        raise ValueError(msg)
    rounds = _rounds(passes, nchain)
    if not (32 <= threads <= 1024 and threads % 32 == 0):
        msg = f"threads={threads}: a multiple of 32 in [32, 1024]"
        raise ValueError(msg)
    if on_cpu(x, "fma_sweep_cuda"):
        return fma_rate_plain(x, passes, nchain)
    dev = x.device
    ptr = require(x, "x", tuple(x.shape), torch.float32, dev)
    out = torch.empty_like(x)
    launch("f2d_fma_sweep", dev, ptr, out.data_ptr(), x.numel(), rounds, nchain, threads, _C1, _C2)
    fma_sweep_cuda.launches += 1
    return out


fma_sweep_cuda.launches = 0


# --- C5e, C5f: geometry twin ----------------------------------------------------------


class GeometryOperands:
    """The operands of one geometry twin, checked once: per-channel float32
    inputs (all of one shape, (X, Y) or (C, X, Y)), shared float32 and int8
    (X, Y) inputs, the halo reach `h` and the thread block's row count;
    `n_out` fresh float32 outputs of the per-channel shape, or `outs` (views
    into one tensor, as a packed output is). Inputs may be views into one
    tensor too (a packed or merged plane set). ``nbytes`` counts every
    operand once. On a card it also holds the device table of the pointers
    (int64: per-channel, shared, int8, outputs) that the kernel reads."""

    def __init__(self, chan_in, shared_in=(), i8_in=(), n_out: int = 1, h: int = 0,
                 block_rows: int = 8, outs=None):
        if not chan_in or (outs is None and n_out < 1) or (outs is not None and not outs):
            msg = "a geometry twin needs a per-channel input and an output"
            raise ValueError(msg)
        if h < 0 or not 1 <= block_rows <= 32:
            msg = f"h={h}, block_rows={block_rows}: h ≥ 0 and 1 ≤ block_rows ≤ 32"
            raise ValueError(msg)
        first = chan_in[0]
        dev, shape = first.device, tuple(first.shape)
        if len(shape) not in (2, 3):
            msg = f"geometry twin inputs are (X, Y) or (C, X, Y), got {shape}"
            raise ValueError(msg)
        plane = shape[-2:]
        ptrs = [require(t, f"chan_in[{k}]", shape, torch.float32, dev)
                for k, t in enumerate(chan_in)]
        ptrs += [require(t, f"shared_in[{k}]", plane, torch.float32, dev)
                 for k, t in enumerate(shared_in)]
        ptrs += [require(t, f"i8_in[{k}]", plane, torch.int8, dev) for k, t in enumerate(i8_in)]
        if outs is None:
            outs = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(n_out)]
        ptrs += [require(o, f"outs[{k}]", shape, torch.float32, dev) for k, o in enumerate(outs)]
        self.chan_in, self.shared_in, self.i8_in = list(chan_in), list(shared_in), list(i8_in)
        self.outs = tuple(outs)
        self.h, self.block_rows, self.device = h, block_rows, dev
        self.channels = shape[0] if len(shape) == 3 else 1
        self.plane = plane
        self.nbytes = operand_bytes(*self.chan_in, *self.shared_in, *self.i8_in, *self.outs)
        self.table = None if dev.type == "cpu" else torch.tensor(ptrs, dtype=torch.int64).to(dev)


def geometry_twin_plain(ops: GeometryOperands) -> tuple[torch.Tensor, ...]:
    """The kernel's sum as torch ops: per input in table order (per-channel,
    shared, int8 widened), the value at the cell and, with a reach h, at rows
    clamp(i − h) and clamp(i + h); written to one fresh tensor per output."""
    x_rows, y_cols = ops.plane
    c = ops.channels
    rows = torch.arange(x_rows, device=ops.device)
    lo, hi = (rows - ops.h).clamp(0, x_rows - 1), (rows + ops.h).clamp(0, x_rows - 1)
    acc = torch.zeros((c, x_rows, y_cols), dtype=torch.float32, device=ops.device)
    for t in (*ops.chan_in, *ops.shared_in, *ops.i8_in):
        t = t.to(torch.float32).reshape(-1, x_rows, y_cols)
        acc = acc + t
        if ops.h > 0:
            acc = acc + t.index_select(1, lo)
            acc = acc + t.index_select(1, hi)
    return tuple(acc.reshape(o.shape).clone() for o in ops.outs)


def geometry_twin_cuda(ops: GeometryOperands) -> tuple[torch.Tensor, ...]:
    """The geometry twin over `ops`: on a card, the kernel writes the sum
    into ``ops.outs`` and returns them."""
    if on_cpu(ops.chan_in[0], "geometry_twin_cuda"):
        return geometry_twin_plain(ops)
    launch("f2d_geometry_twin", ops.device, ops.table.data_ptr(), len(ops.chan_in),
           len(ops.shared_in), len(ops.i8_in), len(ops.outs), *ops.plane, ops.channels, ops.h,
           ops.block_rows)
    geometry_twin_cuda.launches += 1
    return ops.outs


geometry_twin_cuda.launches = 0


# --- C5g: row window ------------------------------------------------------------------

ROW_WINDOW_SMEM = 232_448  # shared memory one block may use on the H100 (bytes)
# the kernel's static shared memory: its 8-byte barrier, padded to the window's
# 128-byte alignment (nvcc -Xptxas -v: "128 bytes smem")
_STATIC_SMEM = 128


def row_window_tile(x_rows: int, y_cols: int, h: int = 8) -> int | None:
    """The largest t, a multiple of 8 dividing `x_rows`, whose float32
    window of t + 2h rows of `y_cols` fits a block's shared memory beside
    the kernel's barrier; None when no t does."""
    fits = [t for t in range(8, x_rows // 2 + 1, 8)
            if x_rows % t == 0 and t % h == 0
            and (t + 2 * h) * y_cols * 4 + _STATIC_SMEM <= ROW_WINDOW_SMEM]
    return max(fits) if fits else None


def _window_rows(x_rows: int, t: int, h: int) -> torch.Tensor:
    """(X/t, t + 2h) row indices of each tile's window, its first row
    clamped as ``scripts/dma_rowwin_1600_check.py:38`` clamps it."""
    tiles = torch.arange(x_rows // t)
    r0 = (tiles * (t // h) - 1).clamp(0, (x_rows - t) // h - 2) * h
    return r0[:, None] + torch.arange(t + 2 * h)[None, :]


def row_window_plain(a: torch.Tensor, t: int, h: int = 8) -> torch.Tensor:
    """The copy as tensor ops: each tile's window gathered, the first and
    last realigned (shifted by h, the edge row replicated), ``2 ·
    window[h : h + t]`` stacked."""
    x_rows, y_cols = a.shape
    win = a[_window_rows(x_rows, t, h).to(a.device)]  # (X/t, t + 2h, Y)
    win[0, h:] = win[0, :-h].clone()
    win[0, :h] = win[0, h]
    win[-1, :-h] = win[-1, h:].clone()
    win[-1, -h:] = win[-1, -h - 1]
    return (2.0 * win[:, h:h + t]).reshape(x_rows, y_cols)


def row_window_cuda(a: torch.Tensor, t: int, h: int = 8) -> torch.Tensor:
    """``2 · a`` through the row windows of tiles of t rows (reach h) of a
    contiguous (X, Y) float32 plane; returns a fresh (X, Y) tensor."""
    x_rows, y_cols = a.shape
    if x_rows % t or t % h or x_rows // t < 2 or (x_rows - t) // h < 2:
        msg = f"row_window: t={t}, h={h} do not tile {x_rows} rows (X % t, t % h, X/t ≥ 2)"
        raise ValueError(msg)
    if on_cpu(a, "row_window_cuda"):
        return row_window_plain(a, t, h)
    dev = a.device
    ptr = require(a, "a", (x_rows, y_cols), torch.float32, dev)
    if ptr % 16 or (y_cols * 4) % 16:
        msg = "row_window_cuda: bulk copies need 16-byte aligned rows (the base and Y·4)"
        raise ValueError(msg)
    window = (t + 2 * h) * y_cols * 4
    if window + _STATIC_SMEM > ROW_WINDOW_SMEM:
        msg = f"row_window_cuda: a window of {window} bytes does not fit {ROW_WINDOW_SMEM}"
        raise ValueError(msg)
    out = torch.empty_like(a)
    launch("f2d_row_window", dev, ptr, out.data_ptr(), x_rows, y_cols, t, h)
    row_window_cuda.launches += 1
    return out


row_window_cuda.launches = 0


# --- C6: the el-op counter's toy kernels ----------------------------------------------

TOY_OPS = ("mul2add1", "div3", "mul3")  # x·2 + 1, x/3, x·3


def toy_elementwise_plain(x: torch.Tensor, op: str) -> torch.Tensor:
    """The toy as the JAX test writes it: ``x * 2.0 + 1.0``, ``x / 3.0`` or
    ``x * 3.0``."""
    if op == "mul2add1":
        return x * 2.0 + 1.0
    if op == "div3":
        return x / 3.0
    if op == "mul3":
        return x * 3.0
    msg = f"op {op!r}: one of {TOY_OPS}"
    raise ValueError(msg)


def toy_elementwise_cuda(x: torch.Tensor, op: str) -> torch.Tensor:
    """Toy `op` over a contiguous float32 tensor; a fresh tensor."""
    if op not in TOY_OPS:
        msg = f"op {op!r}: one of {TOY_OPS}"
        raise ValueError(msg)
    if on_cpu(x, "toy_elementwise_cuda"):
        return toy_elementwise_plain(x, op)
    dev = x.device
    ptr = require(x, "x", tuple(x.shape), torch.float32, dev)
    out = torch.empty_like(x)
    c = {"mul2add1": 2.0, "div3": recip32(3.0), "mul3": 3.0}[op]
    launch("f2d_toy_elementwise", dev, ptr, out.data_ptr(), x.numel(), TOY_OPS.index(op), c)
    toy_elementwise_cuda.launches += 1
    return out


toy_elementwise_cuda.launches = 0
