"""Argument checks and launch plumbing shared by the kernel wrappers.

A wrapper hands raw pointers to a C entry point, so everything the
kernel assumes is checked here first: device, dtype, shape, contiguity.
A field is stored as float32 or bfloat16 (the transport dtype,
``SimConfig.dtype``); each C entry point has one version per storage type,
``f2d_<kernel>`` and ``f2d_<kernel>_bf16`` (:func:`entry`).
The kernel library is imported and built only when a CUDA tensor is
launched on, never when a module is imported.

The byte ledger: while ``TRAFFIC_LOG`` is a list, every phase wrapper
appends ``(kernel name with variant, bytes)`` on entry, before it routes by
device, so the ledger is the same whether the plain version or the kernel
runs. The bytes are those of the input and output operands of the kernel's
C entry point (scratch excluded). ``None`` (the default) logs nothing, and
each wrapper tests it before it counts a byte, so the ledger costs one
attribute read per call while it is off.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["on_cpu", "require", "require_no_alias", "launch", "recip32", "TRAFFIC_LOG",
           "log_traffic", "operand_bytes", "STORAGE_DTYPES", "entry"]

STORAGE_DTYPES = (torch.float32, torch.bfloat16)  # the kernels' field storage types

TRAFFIC_LOG: list[tuple[str, int]] | None = None


def operand_bytes(*tensors: torch.Tensor) -> int:
    """Bytes of the given operands, each counted once in full."""
    return sum(t.numel() * t.element_size() for t in tensors)


def log_traffic(name: str, nbytes: int) -> None:
    """Append ``(name, nbytes)`` to ``TRAFFIC_LOG`` when it is a list."""
    if TRAFFIC_LOG is not None:
        TRAFFIC_LOG.append((name, nbytes))


def recip32(x: float) -> float:
    """The float32 multiplier by which PyTorch's CUDA kernels compute
    ``tensor / x`` for a Python scalar x: 1/x in double, rounded once to
    float32 (checked on an H100 with torch 2.11: bit-equal to the division
    where the float32 reciprocal of float32(x) is not). The kernels multiply
    by this where the eager path divides by a constant."""
    return float(np.float32(1.0 / x))


def entry(name: str, dtype: torch.dtype) -> str:
    """The C entry point of kernel `name` for fields stored as `dtype`;
    raises for a dtype the kernels do not store."""
    if dtype not in STORAGE_DTYPES:
        msg = f"{name}: fields stored as {dtype}; the kernels take float32 or bfloat16"
        raise TypeError(msg)
    return name + ("_bf16" if dtype == torch.bfloat16 else "")


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


def require_no_alias(outs, ins, wrapper: str) -> None:
    """Raise if any output tensor shares a byte of storage with any input
    (a kernel reads its inputs through read-only restrict pointers)."""
    for o in outs:
        o_lo = o.data_ptr()
        o_hi = o_lo + o.numel() * o.element_size()
        for t in ins:
            t_lo = t.data_ptr()
            if t.device == o.device and t_lo < o_hi and o_lo < t_lo + t.numel() * t.element_size():
                msg = f"{wrapper}: an output aliases an input"
                raise ValueError(msg)


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry point `entry` of the kernel library on `device`'s
    current stream (appended as the last argument); raise on a CUDA
    error."""
    from fluid2d_tpu_torch.ops import _build

    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    _build.check(lib, rc, entry)
