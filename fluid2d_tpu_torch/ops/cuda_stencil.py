"""Pressure iterations, red-black SOR and Jacobi, and the standalone CIP
advection: the CUDA kernels and their plain PyTorch versions (the
counterpart of ``fluid2d_tpu/ops/pallas_stencil.py``).

Source notes.

``sor_iteration_cuda``
  Replaces: ``fluid2d_tpu/ops/pallas_stencil.py:sor_iteration_pallas``
  (core ``_sor_core``) — only what it computes, not its fetch variants
  (halo triples, element windows, sliding DMA) or tile cost model.
  Kernel: ``fluid2d_tpu_torch/csrc/sor.cu``, one thread per cell, three
  launches (BC, odd sweep, even sweep in place; the limiter rides the
  even-sweep launch).
  Bound on the H100: bytes. Per iteration it reads p, p_alt, u, w and two
  int8 planes and writes two (four with the limiter) planes, at about
  25 flops per cell: far below the card's flop:byte balance.
  What the design does about it: nothing yet. Each launch re-reads its
  inputs from device memory (the neighbours mostly hit L1/L2); fusing the
  three launches with a per-tile halo is later work.

``jacobi_iteration_cuda``
  Replaces: ``fluid2d_tpu/ops/pallas_stencil.py:jacobi_iteration_pallas``
  (kernel ``_jacobi_kernel``): up to four fused Jacobi iterations, the
  limiter folded into the last.
  Kernel: ``fluid2d_tpu_torch/csrc/jacobi.cu``, one thread per cell, two
  launches per iteration (BC out of place, then the sweep over every
  not-wall cell; the limiter rides the last sweep). The BC and
  ``predict_p`` are ``csrc/pressure.cuh``, shared with SOR.
  Bound on the H100: bytes, as SOR: per iteration it reads p, p_alt, u, w
  and two int8 planes and writes two planes, ~25 flops per cell.
  What the design does about it: nothing yet. The Pallas kernel keeps all
  iterations of a call in VMEM with a 2-row halo per iteration; here every
  iteration's pair goes through device memory (mostly L2 at 3200×1600,
  20 MB per plane). Fusing the iterations with a per-tile halo is later
  work.

``cip_advect_cuda`` (C1)
  Replaces: ``fluid2d_tpu/ops/pallas_stencil.py:948 cip_advect_pallas``
  (body ``_cip_kernel`` :913): ``where(fluid, cip_advect(f, fx, fy, vel),
  alt)`` per output, C channels, the velocity given or ``vel is f`` (the
  velocity advecting itself).
  Kernel: ``fluid2d_tpu_torch/csrc/cip_phases.cu`` ``f2d_cip_advect``, the
  advection stage of the CIP phases (``advect_kernel``,
  ``csrc/cip_advect.cuh``) with its planes at the storage type: one launch,
  one thread per cell, channels on ``blockIdx.z``, no clamp.
  Bound on the H100: bytes. At 3200×1600 float32 the dye form (C = 3, a
  separate velocity) moves 29 planes and the mask, 599.0 MB (0.179 ms at
  3.35 TB/s); the velocity form (C = 2, ``vel is f``) 373.8 MB (0.112 ms);
  about 120 flops per cell and channel (0.03 ms at 67 TFLOP/s).
  What the design does about it: nothing yet, as the phases' advection
  stage: the upwind and gradient neighbours are read from device memory and
  mostly hit L1/L2.
  Storage: every field float32 or bfloat16, one dtype per call; bf16 is
  widened on load, the arithmetic is float32 and each output is rounded
  once, so a bf16 call is bit-identical to its plain version on the card, as
  ``_cip_kernel``'s ``_ext`` / ``_cast_store`` round. Ledger names:
  ``cip_advect`` (a separate velocity, C = 3) and ``cip_advect_self``
  (``vel is f``, C = 2), the two registered forms; any other channel count
  appends ``_c<C>``.

Storage. The velocity ``u, w`` (and the limited velocity) is stored in the
state's transport dtype, float32 or bfloat16. The pressure pair read and
the pair returned are each that dtype or float32: a solve of several calls
keeps its pair in float32 between calls and rounds it once, at the end, as
the JAX package's jnp path does (``fluid2d_tpu/models/common.py:98-119``).
So a call is one link of a chain: at bf16 the first reads bf16 and returns
float32 (``out_dtype=torch.float32``), the middle ones read and return
float32, the last returns bf16; a lone call reads and returns bf16. The
byte ledger names a link whose pair differs from the velocity's dtype
(``_f32in``, ``_f32out``). Arithmetic is float32 throughout.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops import launch as _launch
from fluid2d_tpu_torch.ops.cip import cip_advect
from fluid2d_tpu_torch.ops.launch import (
    STORAGE_DTYPES,
    launch,
    log_traffic,
    on_cpu,
    operand_bytes,
    recip32,
    require,
    require_no_alias,
)
from fluid2d_tpu_torch.ops.limiters import limit_vector_norm
from fluid2d_tpu_torch.ops.pressure import jacobi_pressure_iteration, sor_pressure_iteration
from fluid2d_tpu_torch.utils.dtypes import f32, to_transport

__all__ = [
    "sor_iteration_cuda",
    "sor_iteration_plain",
    "jacobi_iteration_cuda",
    "jacobi_iteration_plain",
    "JACOBI_MAX_ITERS",
    "cip_advect_cuda",
    "cip_advect_plain",
    "cip_advect_name",
]

JACOBI_MAX_ITERS = 4  # iterations one jacobi_iteration_cuda call runs at most


def _link(p_cur, p_alt, u, w, out_dtype, wrapper: str):
    """The dtypes of one call: ``(velocity's, pair read, pair returned)``.
    The pair read is p_cur's (p_alt must match; w must match u); the pair
    returned is `out_dtype`, by default the pair read's. Each pair is the
    velocity's dtype or float32; anything else raises."""
    sd, in_dt = u.dtype, p_cur.dtype
    out_dt = in_dt if out_dtype is None else out_dtype
    if sd not in STORAGE_DTYPES or w.dtype != sd:
        msg = f"{wrapper}: u, w are {u.dtype}, {w.dtype}; expected one of {STORAGE_DTYPES}"
        raise TypeError(msg)
    for what, dt in (("p_cur", in_dt), ("p_alt", p_alt.dtype), ("the returned pair", out_dt)):
        if dt not in (sd, torch.float32):
            msg = f"{wrapper}: {what} is {dt}; expected {sd} (the velocity's) or torch.float32"
            raise TypeError(msg)
    if p_alt.dtype != in_dt:
        msg = f"{wrapper}: p_alt is {p_alt.dtype}, p_cur {in_dt}"
        raise TypeError(msg)
    return sd, in_dt, out_dt


def _log_pressure(name, p_cur, p_alt, u, w, code8, mask8, v_limit, out_dt) -> None:
    """Ledger entry of a pressure call: six input planes, the output pair,
    and the limited (2, X, Y) velocity when the limiter rides along. A link
    whose pair is float32 while the velocity is not is named for it."""
    name += "_f32in" if p_cur.dtype != u.dtype else ""
    name += "_f32out" if out_dt != u.dtype else ""
    pair_out = 2 * p_cur.numel() * out_dt.itemsize
    outs = pair_out + (0 if v_limit is None else operand_bytes(u, w))
    log_traffic(name + ("" if v_limit is None else "_v_limit"),
                operand_bytes(p_cur, p_alt, u, w, code8, mask8) + outs)


def _finish(pair, u32, w32, out_dt, sd, v_limit):
    """The plain versions' ending: the pair rounded once to `out_dt`, and
    the velocity limited in float32 and rounded once to `sd` when asked
    (``fluid2d_tpu/models/common.py:146``)."""
    pair = tuple(to_transport(a, out_dt) for a in pair)
    if v_limit is None:
        return pair
    return (*pair, to_transport(limit_vector_norm(torch.stack([u32, w32]), v_limit), sd))


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _scratch(shape, dev, wanted: bool):
    return torch.empty(shape, dtype=torch.float32, device=dev) if wanted else None


class _SorMasks:
    """The three scene leaves ``sor_pressure_iteration`` reads, rebuilt
    from the kernel's operands (parity is the global (i + j) % 2)."""

    def __init__(self, pbc_code: torch.Tensor, fluid8: torch.Tensor):
        x_rows, y_cols = fluid8.shape
        ii = torch.arange(x_rows, device=fluid8.device)[:, None]
        jj = torch.arange(y_cols, device=fluid8.device)[None, :]
        odd = (ii + jj) % 2 == 1
        fluid = fluid8 != 0
        self.pbc_code = pbc_code
        self.odd_fluid = fluid & odd
        self.even_fluid = fluid & ~odd


def sor_iteration_plain(p_cur, p_alt, u, w, pbc_code, fluid8, omega: float, dt: float,
                        dx: float, *, v_limit: float | None = None,
                        out_dtype: torch.dtype | None = None):
    """One SOR iteration composed from the eager ops, exactly as
    ``fluid2d_tpu/ops/pressure.py`` and ``models/common.py:146`` compose
    them, in float32. Returns ``(p_cur, p_alt)`` as `out_dtype`, plus the
    norm-limited ``(2, X, Y)`` velocity in u's dtype when `v_limit` is
    given."""
    sd, _, out_dt = _link(p_cur, p_alt, u, w, out_dtype, "sor_iteration_plain")
    u32, w32 = f32(u), f32(w)
    pair = sor_pressure_iteration(f32(p_cur), f32(p_alt), u32, w32, _SorMasks(pbc_code, fluid8),
                                  omega, dt, dx)
    return _finish(pair, u32, w32, out_dt, sd, v_limit)


def sor_iteration_cuda(p_cur, p_alt, u, w, pbc_code, fluid8, omega: float, dt: float,
                       dx: float, *, v_limit: float | None = None,
                       out_dtype: torch.dtype | None = None):
    """One red-black SOR iteration (pressure BC, odd sweep, even sweep),
    with the velocity-norm limiter folded in when `v_limit` is given; the
    pair is returned as `out_dtype` (default: p_cur's), one link of a chain
    (module notes).

    CPU tensors take :func:`sor_iteration_plain`. CUDA tensors launch
    ``csrc/sor.cu``; anything the kernel does not take (dtype, shape,
    layout, mixed devices) raises. Outputs are fresh tensors.
    """
    sd, in_dt, out_dt = _link(p_cur, p_alt, u, w, out_dtype, "sor_iteration_cuda")
    if _launch.TRAFFIC_LOG is not None:
        _log_pressure("sor_iteration", p_cur, p_alt, u, w, pbc_code, fluid8, v_limit, out_dt)
    if on_cpu(p_cur, "sor_iteration_cuda"):
        return sor_iteration_plain(p_cur, p_alt, u, w, pbc_code, fluid8, omega, dt, dx,
                                   v_limit=v_limit, out_dtype=out_dt)
    dev = p_cur.device
    x_rows, y_cols = p_cur.shape
    plane = (x_rows, y_cols)
    i8 = torch.int8
    ptrs = [
        require(p_cur, "p_cur", plane, in_dt, dev),
        require(p_alt, "p_alt", plane, in_dt, dev),
        require(u, "u", plane, sd, dev),
        require(w, "w", plane, sd, dev),
        require(pbc_code, "pbc_code", plane, i8, dev),
        require(fluid8, "fluid8", plane, i8, dev),
    ]
    p_out = torch.empty(plane, dtype=out_dt, device=dev)
    p_bc = torch.empty_like(p_out)
    v_lim = None if v_limit is None else torch.empty((2, x_rows, y_cols), dtype=sd, device=dev)
    consts = (omega, 1.0 - omega, dx, recip32(8 * dt), 0.0 if v_limit is None else v_limit)
    if sd == torch.float32:
        launch("f2d_sor_iteration", dev, *ptrs, p_out.data_ptr(), p_bc.data_ptr(), _ptr(v_lim),
               x_rows, y_cols, *consts)
    else:
        # A bf16 pair returned is rounded from float planes kept beside it.
        narrow = out_dt != torch.float32
        wide = [_scratch(plane, dev, True) if narrow else t for t in (p_out, p_bc)]
        launch("f2d_sor_iteration_bf16", dev, *ptrs, p_out.data_ptr(), p_bc.data_ptr(),
               *(t.data_ptr() for t in wide), _ptr(v_lim), x_rows, y_cols,
               int(in_dt != torch.float32), int(narrow), *consts)
    sor_iteration_cuda.launches += 1
    if v_lim is None:
        return p_out, p_bc
    return p_out, p_bc, v_lim


sor_iteration_cuda.launches = 0  # kernel runs (any number of __global__ launches each)


class _JacobiMasks:
    """The two scene leaves ``jacobi_pressure_iteration`` reads, rebuilt
    from the kernel's operands."""

    def __init__(self, pbc_code: torch.Tensor, not_wall8: torch.Tensor):
        self.pbc_code = pbc_code
        self.not_wall = not_wall8 != 0


def _check_n_iters(n_iters: int) -> None:
    if not 1 <= n_iters <= JACOBI_MAX_ITERS:
        msg = f"n_iters={n_iters}: one Jacobi call runs 1..{JACOBI_MAX_ITERS} iterations"
        raise ValueError(msg)


def jacobi_iteration_plain(p_cur, p_alt, u, w, pbc_code, not_wall8, dt: float, dx: float, *,
                           n_iters: int = 1, v_limit: float | None = None,
                           out_dtype: torch.dtype | None = None):
    """`n_iters` chained Jacobi iterations composed from the eager ops, as
    ``fluid2d_tpu/models/common.py:108-116`` chains
    ``jacobi_pressure_iteration``, in float32. Returns ``(p_cur, p_alt)`` as
    `out_dtype`, plus the norm-limited ``(2, X, Y)`` velocity in u's dtype
    when `v_limit` is given."""
    _check_n_iters(n_iters)
    sd, _, out_dt = _link(p_cur, p_alt, u, w, out_dtype, "jacobi_iteration_plain")
    masks = _JacobiMasks(pbc_code, not_wall8)
    u32, w32 = f32(u), f32(w)
    pair = (f32(p_cur), f32(p_alt))
    for _ in range(n_iters):
        pair = jacobi_pressure_iteration(*pair, u32, w32, masks, dt, dx)
    return _finish(pair, u32, w32, out_dt, sd, v_limit)


def jacobi_iteration_cuda(p_cur, p_alt, u, w, pbc_code, not_wall8, dt: float, dx: float, *,
                          n_iters: int = 1, v_limit: float | None = None,
                          out_dtype: torch.dtype | None = None):
    """`n_iters` (1..4) Jacobi iterations (pressure BC, then the sweep of
    every not-wall cell) in one kernel run, with the velocity-norm limiter
    folded in when `v_limit` is given; the pair is returned as `out_dtype`
    (default: p_cur's), one link of a chain (module notes).

    CPU tensors take :func:`jacobi_iteration_plain`. CUDA tensors launch
    ``csrc/jacobi.cu``; anything the kernel does not take raises. Outputs
    are fresh tensors.
    """
    _check_n_iters(n_iters)
    sd, in_dt, out_dt = _link(p_cur, p_alt, u, w, out_dtype, "jacobi_iteration_cuda")
    if _launch.TRAFFIC_LOG is not None:
        _log_pressure(f"jacobi_iteration_n{n_iters}", p_cur, p_alt, u, w, pbc_code, not_wall8,
                      v_limit, out_dt)
    if on_cpu(p_cur, "jacobi_iteration_cuda"):
        return jacobi_iteration_plain(p_cur, p_alt, u, w, pbc_code, not_wall8, dt, dx,
                                      n_iters=n_iters, v_limit=v_limit, out_dtype=out_dt)
    dev = p_cur.device
    x_rows, y_cols = p_cur.shape
    plane = (x_rows, y_cols)
    i8 = torch.int8
    ptrs = [
        require(p_cur, "p_cur", plane, in_dt, dev),
        require(p_alt, "p_alt", plane, in_dt, dev),
        require(u, "u", plane, sd, dev),
        require(w, "w", plane, sd, dev),
        require(pbc_code, "pbc_code", plane, i8, dev),
        require(not_wall8, "not_wall8", plane, i8, dev),
    ]
    p_out = torch.empty(plane, dtype=out_dt, device=dev)
    p_bc = torch.empty_like(p_out)
    # The scratch pair holds the iterations of the other parity than the last.
    scratch = [_scratch(plane, dev, n_iters > 1) for _ in range(2)]
    v_lim = None if v_limit is None else torch.empty((2, x_rows, y_cols), dtype=sd, device=dev)
    consts = (dx, recip32(8 * dt), 0.0 if v_limit is None else v_limit)
    if sd == torch.float32:
        launch("f2d_jacobi_iteration", dev, *ptrs, p_out.data_ptr(), p_bc.data_ptr(),
               *(_ptr(t) for t in scratch), _ptr(v_lim), x_rows, y_cols, n_iters, *consts)
    else:
        # A bf16 pair returned is rounded from float planes kept beside it.
        narrow = out_dt != torch.float32
        wide = [_scratch(plane, dev, True) if narrow else t for t in (p_out, p_bc)]
        launch("f2d_jacobi_iteration_bf16", dev, *ptrs, p_out.data_ptr(), p_bc.data_ptr(),
               *(t.data_ptr() for t in wide), *(_ptr(t) for t in scratch), _ptr(v_lim),
               x_rows, y_cols, n_iters, int(in_dt != torch.float32), int(narrow), *consts)
    jacobi_iteration_cuda.launches += 1
    if v_lim is None:
        return p_out, p_bc
    return p_out, p_bc, v_lim


jacobi_iteration_cuda.launches = 0  # kernel runs (two __global__ launches per iteration each)


# --- C1: standalone CIP advection ---------------------------------------------------

# the registered forms: ledger name → channel count
_ADVECT_FORMS = {"cip_advect": 3, "cip_advect_self": 2}


def cip_advect_name(chans: int, vel_is_f: bool) -> str:
    """The byte ledger's name of one standalone advection call."""
    base = "cip_advect_self" if vel_is_f else "cip_advect"
    return base if _ADVECT_FORMS[base] == chans else f"{base}_c{chans}"


def cip_advect_plain(f, fx, fy, vel, alt_f, alt_fx, alt_fy, fluid8, dt: float, dx: float):
    """``where(fluid8 != 0, cip_advect(f, fx, fy, vel[0], vel[1]), alt)`` per
    output, composed from the eager ops in float32 (``ops/cip.py``) and
    rounded once to f's dtype. Returns ``(f, fx, fy)`` advected."""
    fluid = fluid8 != 0
    vel32 = f32(vel)
    cand = cip_advect(f32(f), f32(fx), f32(fy), vel32[0], vel32[1], dt, dx)
    return tuple(torch.where(fluid, c, f32(a)).to(f.dtype)
                 for c, a in zip(cand, (alt_f, alt_fx, alt_fy)))


def cip_advect_cuda(f, fx, fy, vel, alt_f, alt_fx, alt_fy, fluid8, dt: float, dx: float, *,
                    out=None):
    """Standalone CIP advection (the JAX package's ``cip_advect_pallas``):
    ``where(fluid, cip_advect(f, fx, fy, vel[0], vel[1]), alt)`` per output.
    f, fx, fy and the alternates are (C, X, Y), `vel` (2, X, Y); pass
    ``vel is f`` for a velocity advecting itself (f's first two planes carry
    it, read once). Every field float32 or bfloat16, one dtype; fluid8 (X, Y)
    int8. Returns ``(f, fx, fy)`` advected, fresh tensors, or `out` (three
    tensors shaped as f) when given; an output that aliases an input raises.

    CPU tensors take :func:`cip_advect_plain`. CUDA tensors launch
    ``csrc/cip_phases.cu`` ``f2d_cip_advect``; anything the kernel does not
    take raises.
    """
    vel_is_f = vel is f
    if f.dim() != 3 or (vel_is_f and f.shape[0] < 2):
        msg = (f"cip_advect_cuda: f is (C, X, Y), C ≥ 2 when the velocity is f; "
               f"got {tuple(f.shape)}")
        raise ValueError(msg)
    if f.dtype not in STORAGE_DTYPES:
        msg = f"cip_advect_cuda: f is {f.dtype}; expected one of {STORAGE_DTYPES}"
        raise TypeError(msg)
    ins = (f, fx, fy, vel, alt_f, alt_fx, alt_fy, fluid8)
    if out is not None:
        require_no_alias(out, ins, "cip_advect_cuda")
    chans = f.shape[0]
    if _launch.TRAFFIC_LOG is not None:
        operands = ins if not vel_is_f else (f, fx, fy, alt_f, alt_fx, alt_fy, fluid8)
        log_traffic(cip_advect_name(chans, vel_is_f), operand_bytes(*operands)
                    + 3 * operand_bytes(f))
    if on_cpu(f, "cip_advect_cuda"):
        got = cip_advect_plain(*ins, dt, dx)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return tuple(out)
    dev, sd = f.device, f.dtype
    _, x_rows, y_cols = f.shape
    field, vec, plane = (chans, x_rows, y_cols), (2, x_rows, y_cols), (x_rows, y_cols)
    ptrs = [require(t, name, field, sd, dev)
            for t, name in ((f, "f"), (fx, "fx"), (fy, "fy"))]
    v_ptr = ptrs[0] if vel_is_f else require(vel, "vel", vec, sd, dev)
    ptrs += [v_ptr, v_ptr + x_rows * y_cols * f.element_size()]
    ptrs += [require(t, name, field, sd, dev)
             for t, name in ((alt_f, "alt_f"), (alt_fx, "alt_fx"), (alt_fy, "alt_fy"))]
    ptrs.append(require(fluid8, "fluid8", plane, torch.int8, dev))
    if out is None:
        out = tuple(torch.empty_like(f) for _ in range(3))
    else:
        out = tuple(out)
        for k, o in enumerate(out):
            require(o, f"out[{k}]", field, sd, dev)
    launch("f2d_cip_advect", dev, *ptrs, *(o.data_ptr() for o in out), x_rows, y_cols, chans,
           int(sd == torch.bfloat16), dt, dx, dx**2, dx**3, recip32(dx), recip32(dx**2))
    cip_advect_cuda.launches += 1
    return out


cip_advect_cuda.launches = 0
