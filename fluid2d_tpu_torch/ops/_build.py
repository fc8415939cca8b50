"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``fluid2d_tpu_torch/csrc/*.cu`` to an object, one
process per source, all started together, then links the objects into one
shared library with a plain C interface, which is loaded with ``ctypes``. The
library's name carries a hash of the sources and flags, so an edited
source builds anew and an unchanged one is reused. The build happens at
first use, in ``fluid2d_tpu_torch/_build/`` (listed in ``.gitignore``).

No PyTorch headers are compiled (that takes minutes per build); pointers
and the stream cross as ``c_void_p``, ints as ``c_int``, scalars as
``c_float``. Without ``nvcc`` the build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build_library", "load_library", "check"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# sm_90a: Hopper. No --use_fast_math: it changes division, sqrt and
# NaN/denormal behavior. -fmad=false: no FMA contraction, so that the
# kernels round every product as PyTorch's eager ops do and agree with the
# eager path to the bit (csrc/common.cuh says why that matters).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: argument types, in order. A phase kernel's entry point
# takes a bf16 storage flag; a probe with a "_bf16" twin has one entry point
# per storage type, the twin taking the same arguments with bf16 pointers.
_SIGNATURES = {
    # p_cur, p_alt, u, w, pbc_code, fluid8, p_out, p_bc, v_lim, X, Y, n_iters,
    # bf16 storage, in_bf16, out_bf16, omega, 1-omega, dx, 1/(8·dt), v_limit,
    # stream
    "f2d_sor_iteration": [_P] * 9 + [_I] * 6 + [_F] * 5 + [_P],
    # v, v_alt, fluid8, v_out, X, Y, bf16 storage, 1/dx, dt·ε, stream
    "f2d_confinement": [_P] * 4 + [_I] * 3 + [_F] * 2 + [_P],
    # 11 inputs, 6 outputs, X, Y, bf16 storage, dt, dx, dx², dx³, 1/dx,
    # 1/dx², 1/re, 1/(2dx), stream
    "f2d_cip_velocity_phase": [_P] * 17 + [_I] * 3 + [_F] * 8 + [_P],
    # 11 inputs, 6 outputs, X, Y, C, bf16 storage, constants as above, stream
    "f2d_cip_dye_phase": [_P] * 17 + [_I] * 4 + [_F] * 8 + [_P],
    # p_cur, p_alt, u, w, pbc_code, not_wall8, p_out, p_bc, v_lim, X, Y,
    # n_iters, bf16 storage, in_bf16, out_bf16, dx, 1/(8·dt), v_limit, stream
    "f2d_jacobi_iteration": [_P] * 9 + [_I] * 6 + [_F] * 3 + [_P],
    # v, p, v_alt, bc_const, vbc_code, fluid8, v_out, v_bc, X, Y, kk, bf16
    # storage, dt, 1/dx, 1/dx or 1/(6dx), 1/dx², 1/re, stream
    "f2d_mac_velocity_phase": [_P] * 8 + [_I] * 4 + [_F] * 5 + [_P],
    # dye, dye_alt, vel, bc_dye, inflow8, fluid8, d_out, d_bc, X, Y, C, kk,
    # bf16 storage, dt, 1/dx or 1/(6dx), stream
    "f2d_mac_dye_phase": [_P] * 8 + [_I] * 5 + [_F] * 2 + [_P],
    # x, o, n, stream
    "f2d_copy_add1": [_P, _P, _L, _P],
    # plane table, n_f32, n_i8, n_out, cells, stream
    "f2d_mix_twin": [_P] + [_I] * 3 + [_L, _P],
    # plane table, n_f32, n_bf16, n_i8, n_out32, n_out16, cells, stream
    "f2d_mix_twin_bf16": [_P] + [_I] * 5 + [_L, _P],
    # f, fx, fy, u, w, alt_f, alt_fx, alt_fy, fluid8, 3 outputs, X, Y, C,
    # bf16 storage, dt, dx, dx², dx³, 1/dx, 1/dx², stream
    "f2d_cip_advect": [_P] * 12 + [_I] * 4 + [_F] * 6 + [_P],
    # x, o, n, rounds, c1, c2, stream
    "f2d_fma_rate": [_P, _P, _L, _I, _F, _F, _P],
    # x, o, n, rounds, nchain, threads, c1, c2, stream
    "f2d_fma_sweep": [_P, _P, _L, _I, _I, _I, _F, _F, _P],
    # plane table, n_chan, n_shared, n_i8, n_out, X, Y, C, h, block rows, stream
    "f2d_geometry_twin": [_P] + [_I] * 9 + [_P],
    # a, out, X, Y, t, h, ring slots, stream
    "f2d_row_window": [_P, _P] + [_I] * 5 + [_P],
    # x, o, n, op, c, stream
    "f2d_toy_elementwise": [_P, _P, _L, _I, _F, _P],
    # x, o, n (bf16: pairs), steps, mode, c1, c2, c3, stream
    "f2d_dtype_rate": [_P, _P, _L, _I, _I, _F, _F, _F, _P],
    "f2d_dtype_rate_bf16": [_P, _P, _L, _I, _I, _F, _F, _F, _P],
    # x, out, cols, t, mode, stream
    "f2d_row_copy": [_P, _P, _I, _I, _I, _P],
    "f2d_row_copy_bf16": [_P, _P, _I, _I, _I, _P],
    # rgb (X, Y, 3) float32, image (Y, X, 3) uint8, X, Y, stream
    "f2d_to_image": [_P, _P, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    default = cuda_home / "bin" / "nvcc"
    if default.exists():
        return str(default)
    msg = f"nvcc not found (PATH, {default}): the CUDA kernels cannot be built"
    raise RuntimeError(msg)


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfluid2d_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the sources unless a library for them already exists.
    Returns its path. Raises ``RuntimeError`` with nvcc's output on
    failure."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in _sources()]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        outs = [proc.communicate()[0] for proc in procs]  # waits for every process
        for cmd, proc, out in zip(compiles, procs, outs):
            if proc.returncode != 0:
                msg = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
                raise RuntimeError(msg)
        tmp = Path(work) / target.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            msg = f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{proc.stdout}{proc.stderr}"
            raise RuntimeError(msg)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return target


@functools.cache
def load_library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's argtypes set
    (built first if needed)."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.f2d_error_string.argtypes = [ctypes.c_int]
    lib.f2d_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = f"{what}: CUDA error {rc} ({lib.f2d_error_string(rc).decode()})"
        raise RuntimeError(msg)
