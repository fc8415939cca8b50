"""The roofline's probes: the CUDA kernels and their plain PyTorch versions.

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

Each wrapper takes CPU tensors to its plain version and launches its
kernel on CUDA tensors; there is no other path. ``<wrapper>.launches``
counts kernel runs.
"""

from __future__ import annotations

import numpy as np
import torch

from fluid2d_tpu_torch.ops.launch import launch, on_cpu, require

__all__ = [
    "FMA_CHAINS",
    "MixOperands",
    "copy_add1_cuda",
    "copy_add1_plain",
    "mix_twin_bf16_cuda",
    "mix_twin_cuda",
    "mix_twin_plain",
    "fma_rate_cuda",
    "fma_rate_error_bound",
    "fma_rate_plain",
]

FMA_CHAINS = 8  # independent chains per element (csrc/probes.cu:kChains)
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


def _rounds(passes: int) -> int:
    if passes < FMA_CHAINS or passes % FMA_CHAINS:
        msg = f"passes={passes}: a positive multiple of {FMA_CHAINS}"
        raise ValueError(msg)
    return passes // FMA_CHAINS


def _chain_scale(c: int) -> float:
    """The float32 start multiplier of chain c, as the kernel rounds it."""
    return float(np.float32(1.0 + 1e-7 * c))


def fma_rate_plain(x: torch.Tensor, passes: int) -> torch.Tensor:
    """The same chains as torch ops: ``a = a * c1 + c2`` (two roundings
    per step where the kernel's FMA takes one), then the chains' sum."""
    accs = [x * _chain_scale(c) for c in range(FMA_CHAINS)]
    for _ in range(_rounds(passes)):
        accs = [a * _C1 + _C2 for a in accs]
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc


def fma_rate_error_bound(x: torch.Tensor, passes: int) -> float:
    """A bound on |fma_rate_cuda(x, passes) - exact| at any element, where
    exact is the chains' sum in exact arithmetic (``fma_rate_plain`` on
    float64 stands for it). Each step rounds once, by at most u = 2**-24 of
    its result: the start multiply, every FMA (an earlier error grows by c1
    a round) and the FMA_CHAINS - 1 merge adds (partial sums below
    FMA_CHAINS·A). A bounds every chain value: c1**rounds·(|x|·s + rounds·c2),
    with s the largest start multiplier, plus 0.1% for the rounding itself."""
    rounds = _rounds(passes)
    grow = _C1**rounds
    a_max = grow * (float(x.abs().max()) * _chain_scale(FMA_CHAINS - 1) + rounds * _C2) * 1.001
    per_value = 2.0**-24 * a_max
    return per_value * (FMA_CHAINS * (rounds + 1) * grow + FMA_CHAINS * (FMA_CHAINS - 1))


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
