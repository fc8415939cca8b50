"""Pressure iterations, red-black SOR and Jacobi, and the standalone CIP
advection: the CUDA kernels and their plain PyTorch versions (the
counterpart of ``fluid2d_tpu/ops/pallas_stencil.py``).

Source notes.

``sor_iteration_cuda``
  Replaces: ``fluid2d_tpu/ops/pallas_stencil.py:sor_iteration_pallas``
  (core ``_sor_core``, ``n_iters`` 1 or 2) — only what it computes, not its
  fetch variants (halo triples, element windows, sliding DMA) or tile cost
  model.
  Kernel: ``fluid2d_tpu_torch/csrc/sor.cu`` ``sor_fused_kernel``, one
  launch a call: a block runs the BC, the odd and the even sweep of every
  iteration on a 32×32 tile, each stage's values in a shared-memory window
  (three float windows on the tile + 3·n_iters, taken in turn, out of
  place), the halo recomputed per tile; the limiter rides the last stores.
  A step's two iterations are one call (``SOR_MAX_ITERS``), the JAX
  package's greedy two-per-call chain.
  Bound on the H100: bytes. A call reads p, p_alt, u, w and two int8
  planes and writes two planes (four with the limiter), at about 25 flops
  per cell and iteration: far below the card's flop:byte balance. What the
  design does about it: no stage result and no pair between the iterations
  goes through device memory (the three-launch design wrote and re-read the
  BC'd and swept planes, and a step's two calls the pair); a block copies
  its operands into its windows in aligned 16-byte chunks (``cp.async`` at
  float32), and the halo rows a neighbouring tile also reads come from L2;
  a sweep thread relaxes one cell of a pair of neighbours, so no warp idles
  on the other parity, and stores the pair with one store a plane. What
  bounds it now: the fill and the stores, not the stages. The windows of
  two iterations span the tile + 6 rows and + 8 columns, 2.06× the tile's
  cells at 32×32, and a block fills, computes and stores in turn, 5 blocks
  an SM (PERF.md §6: with every stage removed the kernel took 75% of its
  time; larger tiles, which copy less halo, fit fewer blocks and lost).

``jacobi_iteration_cuda``
  Replaces: ``fluid2d_tpu/ops/pallas_stencil.py:jacobi_iteration_pallas``
  (kernel ``_jacobi_kernel``): up to four fused Jacobi iterations, the
  limiter folded into the last.
  Kernel: ``fluid2d_tpu_torch/csrc/jacobi.cu`` ``jacobi_fused_kernel``, one
  launch a call, in the fused SOR's design: a block runs the BC and the
  sweep of every iteration on a 32×32 tile, each stage's values in a
  shared-memory window (p_cur on the tile + 2·n_iters; two windows taken in
  turn, an iteration's BC applied in place at the cells with a code and its
  sweep written to the other window, which holds the alt values), the halo
  recomputed per tile; p_alt read from device memory at the first sweep's
  wall cells only; the limiter rides the last stores. The BC, ``predict_p`` and the
  limiter are the cell rules of ``csrc/pressure.cuh``, shared with SOR.
  Bound on the H100: bytes, as SOR: a call reads p, u, w and two int8
  planes (p_alt at the wall cells) and writes two planes (four with the
  limiter), ~25 flops per cell and iteration. What the design does about
  it: no stage result and no pair between the iterations goes through
  device memory (the two-launch-an-iteration design wrote and re-read
  every BC'd and swept plane), the operands arrive in aligned 16-byte
  chunks and the outputs leave as 4-cell vector stores.

``cip_advect_cuda`` (C1)
  Replaces: ``fluid2d_tpu/ops/pallas_stencil.py:948 cip_advect_pallas``
  (body ``_cip_kernel`` :913): ``where(fluid, cip_advect(f, fx, fy, vel),
  alt)`` per output, C channels, the velocity given or ``vel is f`` (the
  velocity advecting itself).
  Kernel: ``fluid2d_tpu_torch/csrc/cip_phases.cu`` ``f2d_cip_advect``
  (``cip_advect_fused_kernel``), one launch a call: a block owns a 32×32
  tile of every channel, the advection stage of the fused dye phase alone.
  It fills the velocity's two planes on the tile + 1 and the fluid flags
  on the tile once (``cp.async`` at float32), then each channel's f, fx, fy
  on the tile + 1 in turn into the same three shared-memory windows, an
  entry past the grid holding the value at the clamped cell, and runs the
  phases' advection cell (``csrc/cip_advect.cuh:cip_advect_cell``) on them;
  the alternates are read at the non-fluid cells only. With ``vel is f``
  the velocity's windows are channels 0 and 1's f windows, filled once.
  Bound on the H100: bytes. At 3200×1600 float32 the dye form (C = 3, a
  separate velocity) must read f, fx, fy, the velocity and the mask once
  and the alternates at the non-fluid cells, and write 9 planes: 427 MB
  (0.127 ms at 3.35 TB/s; 599.0 MB with every alternate in full); the
  velocity form (C = 2, ``vel is f``) 259 MB (0.077 ms); about 120 flops
  per cell and channel (0.03 ms at 67 TFLOP/s). What the design does about
  it: every plane is read once a call, the velocity and the mask once for
  all channels (one thread a cell, a channel a ``blockIdx.z``, had read
  them once a channel and every neighbour through L1/L2); the halo rows a
  neighbouring tile also reads come from L2.
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

Each wrapper declares its kernel call once, a ``KernelCall``, which
``ops/launch.py:run`` reads for the checks, the byte ledger and the launch.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.cip import cip_advect
from fluid2d_tpu_torch.ops.launch import (
    STORAGE_DTYPES,
    KernelCall,
    bf16_storage,
    on_cpu,
    recip32,
    run,
)
from fluid2d_tpu_torch.ops.limiters import limit_vector_norm
from fluid2d_tpu_torch.ops.pressure import jacobi_pressure_iteration, sor_pressure_iteration
from fluid2d_tpu_torch.utils.dtypes import f32, to_transport
from fluid2d_tpu_torch.utils.trace import span

__all__ = [
    "sor_iteration_cuda",
    "sor_iteration_plain",
    "jacobi_iteration_cuda",
    "jacobi_iteration_plain",
    "SOR_MAX_ITERS",
    "JACOBI_MAX_ITERS",
    "cip_advect_cuda",
    "cip_advect_plain",
    "cip_advect_name",
]

SOR_MAX_ITERS = 2  # iterations one sor_iteration_cuda call runs at most
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


def _pressure_call(wrapper, name, entry, p_cur, p_alt, u, w, code8, mask, n_iters, v_limit,
                   out_dtype, scalars) -> KernelCall:
    """The declared call of an SOR or Jacobi kernel: in, the pair, the
    velocity, the BC codes and the int8 `mask` (name, plane); out, the pair
    and, with `v_limit`, the limited (2, X, Y) velocity, whose pointer is
    null without it (first of the scalars). The kernel's own `scalars` go
    after the storage flags, the limit last. A link whose pair is float32
    while the velocity is not is named for it in the ledger."""
    sd, in_dt, out_dt = _link(p_cur, p_alt, u, w, out_dtype, wrapper)
    x_rows, y_cols = plane = tuple(p_cur.shape)
    name += "_f32in" if in_dt != sd else ""
    name += "_f32out" if out_dt != sd else ""
    limited = [] if v_limit is None else [((2, x_rows, y_cols), sd)]
    return KernelCall(
        wrapper, name + ("" if v_limit is None else "_v_limit"), entry,
        [("p_cur", p_cur, plane, in_dt), ("p_alt", p_alt, plane, in_dt), ("u", u, plane, sd),
         ("w", w, plane, sd), ("pbc_code", code8, plane, torch.int8),
         (mask[0], mask[1], plane, torch.int8)],
        [(plane, out_dt)] * 2 + limited,
        (*(() if limited else (0,)), x_rows, y_cols, n_iters, bf16_storage(wrapper, sd),
         int(in_dt != torch.float32), int(out_dt != torch.float32), *scalars,
         0.0 if v_limit is None else v_limit))


def _finish(pair, u32, w32, out_dt, sd, v_limit):
    """The plain versions' ending: the pair rounded once to `out_dt`, and
    the velocity limited in float32 and rounded once to `sd` when asked
    (``fluid2d_tpu/models/common.py:146``)."""
    pair = tuple(to_transport(a, out_dt) for a in pair)
    if v_limit is None:
        return pair
    return (*pair, to_transport(limit_vector_norm(torch.stack([u32, w32]), v_limit), sd))


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


def _check_n_iters(n_iters: int, most: int, solver: str) -> None:
    if not 1 <= n_iters <= most:
        msg = f"n_iters={n_iters}: one {solver} call runs 1..{most} iterations"
        raise ValueError(msg)


def sor_iteration_plain(p_cur, p_alt, u, w, pbc_code, fluid8, omega: float, dt: float,
                        dx: float, *, n_iters: int = 1, v_limit: float | None = None,
                        out_dtype: torch.dtype | None = None):
    """`n_iters` chained SOR iterations composed from the eager ops, exactly
    as ``fluid2d_tpu/ops/pressure.py`` and ``models/common.py:98-119,146``
    compose them, in float32. Returns ``(p_cur, p_alt)`` as `out_dtype`,
    plus the norm-limited ``(2, X, Y)`` velocity in u's dtype when
    `v_limit` is given."""
    _check_n_iters(n_iters, SOR_MAX_ITERS, "SOR")
    sd, _, out_dt = _link(p_cur, p_alt, u, w, out_dtype, "sor_iteration_plain")
    masks = _SorMasks(pbc_code, fluid8)
    u32, w32 = f32(u), f32(w)
    pair = (f32(p_cur), f32(p_alt))
    for _ in range(n_iters):
        pair = sor_pressure_iteration(*pair, u32, w32, masks, omega, dt, dx)
    return _finish(pair, u32, w32, out_dt, sd, v_limit)


def sor_iteration_cuda(p_cur, p_alt, u, w, pbc_code, fluid8, omega: float, dt: float,
                       dx: float, *, n_iters: int = 1, v_limit: float | None = None,
                       out_dtype: torch.dtype | None = None, out=None):
    """`n_iters` (1 or 2) red-black SOR iterations (pressure BC, odd sweep,
    even sweep each) in one launch, with the velocity-norm limiter folded in
    when `v_limit` is given; the pair is returned as `out_dtype` (default:
    p_cur's), one link of a chain (module notes).

    CPU tensors take :func:`sor_iteration_plain`. CUDA tensors launch
    ``csrc/sor.cu``; anything the kernel does not take (dtype, shape,
    layout, mixed devices) raises. Outputs are fresh tensors, or `out`
    (the pair, and the limited velocity with `v_limit`).
    """
    with span("f2d.phase.sor"):
        _check_n_iters(n_iters, SOR_MAX_ITERS, "SOR")
        call = _pressure_call(
            "sor_iteration_cuda", "sor_iteration" + ("" if n_iters == 1 else f"_n{n_iters}"),
            "f2d_sor_iteration", p_cur, p_alt, u, w, pbc_code, ("fluid8", fluid8), n_iters,
            v_limit, out_dtype, (omega, 1.0 - omega, dx, recip32(8 * dt)))
        return run(call, out, on_cpu(p_cur, call.wrapper), lambda: sor_iteration_plain(
            p_cur, p_alt, u, w, pbc_code, fluid8, omega, dt, dx, n_iters=n_iters, v_limit=v_limit,
            out_dtype=out_dtype))


class _JacobiMasks:
    """The two scene leaves ``jacobi_pressure_iteration`` reads, rebuilt
    from the kernel's operands."""

    def __init__(self, pbc_code: torch.Tensor, not_wall8: torch.Tensor):
        self.pbc_code = pbc_code
        self.not_wall = not_wall8 != 0


def jacobi_iteration_plain(p_cur, p_alt, u, w, pbc_code, not_wall8, dt: float, dx: float, *,
                           n_iters: int = 1, v_limit: float | None = None,
                           out_dtype: torch.dtype | None = None):
    """`n_iters` chained Jacobi iterations composed from the eager ops, as
    ``fluid2d_tpu/models/common.py:108-116`` chains
    ``jacobi_pressure_iteration``, in float32. Returns ``(p_cur, p_alt)`` as
    `out_dtype`, plus the norm-limited ``(2, X, Y)`` velocity in u's dtype
    when `v_limit` is given."""
    _check_n_iters(n_iters, JACOBI_MAX_ITERS, "Jacobi")
    sd, _, out_dt = _link(p_cur, p_alt, u, w, out_dtype, "jacobi_iteration_plain")
    masks = _JacobiMasks(pbc_code, not_wall8)
    u32, w32 = f32(u), f32(w)
    pair = (f32(p_cur), f32(p_alt))
    for _ in range(n_iters):
        pair = jacobi_pressure_iteration(*pair, u32, w32, masks, dt, dx)
    return _finish(pair, u32, w32, out_dt, sd, v_limit)


def jacobi_iteration_cuda(p_cur, p_alt, u, w, pbc_code, not_wall8, dt: float, dx: float, *,
                          n_iters: int = 1, v_limit: float | None = None,
                          out_dtype: torch.dtype | None = None, out=None):
    """`n_iters` (1..4) Jacobi iterations (pressure BC, then the sweep of
    every not-wall cell) in one launch, with the velocity-norm limiter
    folded in when `v_limit` is given; the pair is returned as `out_dtype`
    (default: p_cur's), one link of a chain (module notes).

    CPU tensors take :func:`jacobi_iteration_plain`. CUDA tensors launch
    ``csrc/jacobi.cu``; anything the kernel does not take raises. Outputs
    are fresh tensors, or `out` (the pair, and the limited velocity with
    `v_limit`). Each iteration count is a form of the entry point, counted
    apart as ``f2d_jacobi_iteration.n<n_iters>``.
    """
    with span("f2d.phase.jacobi"):
        _check_n_iters(n_iters, JACOBI_MAX_ITERS, "Jacobi")
        call = _pressure_call(
            "jacobi_iteration_cuda", f"jacobi_iteration_n{n_iters}",
            f"f2d_jacobi_iteration.n{n_iters}", p_cur, p_alt, u, w, pbc_code,
            ("not_wall8", not_wall8), n_iters, v_limit, out_dtype, (dx, recip32(8 * dt)))
        return run(call, out, on_cpu(p_cur, call.wrapper), lambda: jacobi_iteration_plain(
            p_cur, p_alt, u, w, pbc_code, not_wall8, dt, dx, n_iters=n_iters, v_limit=v_limit,
            out_dtype=out_dtype))


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
    with span("f2d.phase.cip_advect"):
        vel_is_f = vel is f
        if f.dim() != 3 or (vel_is_f and f.shape[0] < 2):
            msg = (f"cip_advect_cuda: f is (C, X, Y), C ≥ 2 when the velocity is f; "
                   f"got {tuple(f.shape)}")
            raise ValueError(msg)
        if f.dtype not in STORAGE_DTYPES:
            msg = f"cip_advect_cuda: f is {f.dtype}; expected one of {STORAGE_DTYPES}"
            raise TypeError(msg)
        sd = f.dtype
        field = chans, x_rows, y_cols = tuple(f.shape)
        # the kernel takes the velocity as two plane pointers, u then w
        w_off = x_rows * y_cols * f.element_size()
        vel_in = ([f.data_ptr(), f.data_ptr() + w_off] if vel_is_f else
                  [("vel", vel, (2, x_rows, y_cols), sd), vel.data_ptr() + w_off])
        call = KernelCall(
            "cip_advect_cuda", cip_advect_name(chans, vel_is_f), "f2d_cip_advect",
            [("f", f, field, sd), ("fx", fx, field, sd), ("fy", fy, field, sd), *vel_in,
             ("alt_f", alt_f, field, sd), ("alt_fx", alt_fx, field, sd),
             ("alt_fy", alt_fy, field, sd), ("fluid8", fluid8, (x_rows, y_cols), torch.int8)],
            [(field, sd)] * 3,
            (x_rows, y_cols, chans, int(sd == torch.bfloat16), dt, dx, dx**2, dx**3, recip32(dx),
             recip32(dx**2)))
        return run(call, out, on_cpu(f, call.wrapper), lambda: cip_advect_plain(
            f, fx, fy, vel, alt_f, alt_fx, alt_fy, fluid8, dt, dx))
