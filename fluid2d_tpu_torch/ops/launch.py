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

from fluid2d_tpu_torch.utils.trace import launches, span

__all__ = ["on_cpu", "require", "overlaps", "require_no_alias", "check_out", "outputs",
           "fill_out", "launch", "recip32", "TRAFFIC_LOG", "log_traffic", "operand_bytes",
           "STORAGE_DTYPES", "bf16_storage", "entry"]

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


def require_no_alias(outs, ins, wrapper: str) -> None:
    """Raise if any output tensor shares a byte of storage with any input
    (a kernel reads its inputs through read-only restrict pointers)."""
    if any(overlaps(o, t) for o in outs for t in ins):
        msg = f"{wrapper}: an output aliases an input"
        raise ValueError(msg)


def check_out(out, n: int, ins, wrapper: str) -> None:
    """Check a wrapper's `out=` before it routes by device: `n` tensors, none
    sharing a byte with an input (`ins`). None (fresh outputs) passes."""
    if out is None:
        return
    if len(out) != n:
        msg = f"{wrapper}: out= takes {n} tensors, got {len(out)}"
        raise ValueError(msg)
    require_no_alias(out, ins, wrapper)


def outputs(out, specs, device: torch.device) -> tuple[torch.Tensor, ...]:
    """A kernel's outputs: fresh tensors of `specs` (``(shape, dtype)``
    each) on `device`, or the given `out`, each checked against its spec."""
    if out is None:
        return tuple(torch.empty(shape, dtype=dt, device=device) for shape, dt in specs)
    for k, (o, (shape, dt)) in enumerate(zip(out, specs)):
        require(o, f"out[{k}]", shape, dt, device)
    return tuple(out)


def fill_out(out, got) -> tuple[torch.Tensor, ...]:
    """A plain version's results `got`, or, with `out`, copied into it (each
    checked against its result's shape and dtype) and `out` returned."""
    if out is None:
        return tuple(got)
    for k, (o, g) in enumerate(zip(out, got)):
        require(o, f"out[{k}]", tuple(g.shape), g.dtype, g.device)
        o.copy_(g)
    return tuple(out)


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry point `entry` of the kernel library on `device`'s
    current stream (appended as the last argument); raise on a CUDA
    error. Counts one launch of `entry` once it is enqueued. An `entry`
    with a suffix after a dot (``f2d_mac_velocity_phase.kk``) names a form
    of the C entry point before the dot, which it calls, and is counted
    under its whole name."""
    with span("f2d.launch"):
        from fluid2d_tpu_torch.ops import _build

        lib = _build.load_library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, entry.partition(".")[0])(*args, ctypes.c_void_p(stream))
        _build.check(lib, rc, entry)
        launches[entry] += 1
