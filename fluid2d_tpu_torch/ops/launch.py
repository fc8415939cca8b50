"""Argument checks and launch plumbing shared by the kernel wrappers.

A wrapper hands raw pointers to a C entry point, so everything the
kernel assumes is checked here first: device, dtype, shape, contiguity.
A field is stored as float32 or bfloat16 (the transport dtype,
``SimConfig.dtype``); a C entry point takes a storage flag
(:func:`bf16_storage`) or has one version per storage type,
``f2d_<kernel>`` and ``f2d_<kernel>_bf16`` (:func:`entry`).
The kernel library is imported and built only when a CUDA tensor is
launched on, never when a module is imported. :func:`launch` counts each
call in ``utils/trace.py:launches`` under its entry point, or a form of it
(``<entry>.<form>``), and runs inside the span ``f2d.launch``.

A phase wrapper declares its kernel call once, as a :class:`KernelCall`:
its inputs (name, tensor, shape, dtype) in the C entry point's order, its
outputs' (shape, dtype), its ledger name, its entry point and its trailing
scalars. :func:`run` reads that one declaration for the ``out=`` checks,
the byte ledger, the operand checks and the launch.

The byte ledger: while ``TRAFFIC_LOG`` is a list, :func:`run` appends
``(kernel name with variant, bytes)`` before it routes by device, so the
ledger is the same whether the plain version or the kernel runs. The bytes
are those of the declared inputs, each once, and of the outputs (scratch
excluded). ``None`` (the default) logs nothing and counts no byte, so the
ledger costs one attribute read per call while it is off.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from fluid2d_tpu_torch.utils.trace import launches, span

__all__ = ["on_cpu", "require", "overlaps", "KernelCall", "run", "launch", "recip32",
           "TRAFFIC_LOG", "operand_bytes", "STORAGE_DTYPES", "bf16_storage", "entry"]

STORAGE_DTYPES = (torch.float32, torch.bfloat16)  # the kernels' field storage types

TRAFFIC_LOG: list[tuple[str, int]] | None = None


def operand_bytes(*tensors: torch.Tensor) -> int:
    """Bytes of the given operands, each counted once in full."""
    return sum(t.numel() * t.element_size() for t in tensors)


def recip32(x: float) -> float:
    """The float32 multiplier by which PyTorch's CUDA kernels compute
    ``tensor / x`` for a Python scalar x: 1/x in double, rounded once to
    float32 (checked on an H100 with torch 2.11: bit-equal to the division
    where the float32 reciprocal of float32(x) is not). The kernels multiply
    by this where the eager path divides by a constant."""
    return float(np.float32(1.0 / x))


def bf16_storage(name: str, dtype: torch.dtype) -> int:
    """The storage flag of a C entry point that takes one (1 for bfloat16
    fields, 0 for float32); raises for a dtype the kernels do not store."""
    if dtype not in STORAGE_DTYPES:
        msg = f"{name}: fields stored as {dtype}; the kernels take float32 or bfloat16"
        raise TypeError(msg)
    return int(dtype == torch.bfloat16)


def entry(name: str, dtype: torch.dtype) -> str:
    """The C entry point of kernel `name` for fields stored as `dtype`, for
    the kernels with one entry point per storage type; raises for a dtype
    the kernels do not store."""
    return name + ("_bf16" if bf16_storage(name, dtype) else "")


def on_cpu(t: torch.Tensor, wrapper: str) -> bool:
    """True for a CPU tensor (the wrapper takes its plain version), False
    for a CUDA tensor (it launches its kernel); raises for any other
    device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        msg = f"{wrapper}: unsupported device {t.device}"
        raise ValueError(msg)
    return False


def require(t: torch.Tensor, name: str, shape: tuple[int, ...], dtype: torch.dtype,
            device: torch.device) -> int:
    """Check one kernel operand; return its data pointer."""
    if not isinstance(t, torch.Tensor):
        msg = f"{name}: expected a tensor, got {type(t).__name__}"
        raise TypeError(msg)
    if t.device != device:
        msg = f"{name}: on {t.device}, expected {device}"
        raise ValueError(msg)
    if t.dtype != dtype:
        msg = f"{name}: dtype {t.dtype}, expected {dtype}"
        raise TypeError(msg)
    if tuple(t.shape) != shape:
        msg = f"{name}: shape {tuple(t.shape)}, expected {shape}"
        raise ValueError(msg)
    if not t.is_contiguous():
        msg = f"{name}: not contiguous"
        raise ValueError(msg)
    return t.data_ptr()


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors' byte ranges on one device intersect."""
    a_lo, b_lo = a.data_ptr(), b.data_ptr()
    return (a.device == b.device and a_lo < b_lo + b.numel() * b.element_size()
            and b_lo < a_lo + a.numel() * a.element_size())


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry point `entry` of the kernel library on `device`'s
    current stream (appended as the last argument); raise on a CUDA
    error. Counts one launch of `entry` once it is enqueued. An `entry`
    with a suffix after a dot (``f2d_mac_velocity_phase.kk``,
    ``f2d_jacobi_iteration.n4``) names a form of the C entry point before
    the dot, which it calls, and is counted under its whole name."""
    with span("f2d.launch"):
        from fluid2d_tpu_torch.ops import _build

        lib = _build.load_library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, entry.partition(".")[0])(*args, ctypes.c_void_p(stream))
        _build.check(lib, rc, entry)
        launches[entry] += 1


class KernelCall(NamedTuple):
    """One kernel call as its wrapper declares it, each operand named once."""

    wrapper: str  # the wrapper's name, in messages
    name: str  # the byte ledger's name
    entry: str  # the C entry point, or a form of it (:func:`launch`)
    # (name, tensor, shape, dtype) of each input, in the entry point's order;
    # an int is a pointer passed as it is, neither checked nor counted
    ins: list
    outs: list  # (shape, dtype) of each output, in order
    scalars: tuple  # the arguments after the output pointers


def run(call: KernelCall, out, cpu: bool, plain) -> tuple[torch.Tensor, ...]:
    """Run a declared call. `out` (None: fresh outputs) must hold one tensor
    an output, none sharing a byte with an input (a kernel reads its inputs
    through restrict pointers), checked before the route by device, so the
    plain version refuses what the kernel would. The ledger entry goes
    next. With `cpu` (the wrapper's
    :func:`on_cpu` of its first input) the plain version runs, ``plain()``,
    and its results are copied into `out` when it is given (each checked
    against its result's shape and dtype); otherwise every input is checked
    against its declaration and `out` against the output specs, and the
    kernel is launched."""
    tensors = [a[1] for a in call.ins if not isinstance(a, int)]
    if out is not None:
        if len(out) != len(call.outs):
            msg = f"{call.wrapper}: out= takes {len(call.outs)} tensors, got {len(out)}"
            raise ValueError(msg)
        if any(overlaps(o, t) for o in out for t in tensors):
            msg = f"{call.wrapper}: an output aliases an input"
            raise ValueError(msg)
    if TRAFFIC_LOG is not None:
        TRAFFIC_LOG.append((call.name, operand_bytes(*tensors)
                            + sum(math.prod(shape) * dt.itemsize for shape, dt in call.outs)))
    if cpu:
        got = plain()
        if out is None:
            return tuple(got)
        for k, (o, g) in enumerate(zip(out, got)):
            require(o, f"out[{k}]", tuple(g.shape), g.dtype, g.device)
            o.copy_(g)
        return tuple(out)
    dev = tensors[0].device
    ptrs = [a if isinstance(a, int) else require(a[1], a[0], a[2], a[3], dev) for a in call.ins]
    if out is None:
        out = [torch.empty(shape, dtype=dt, device=dev) for shape, dt in call.outs]
    else:
        for k, (o, (shape, dt)) in enumerate(zip(out, call.outs)):
            require(o, f"out[{k}]", shape, dt, dev)
    launch(call.entry, dev, *ptrs, *(o.data_ptr() for o in out), *call.scalars)
    return tuple(out)
