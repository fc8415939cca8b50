"""Whole-phase kernels of the CIP and MAC steps: the CUDA kernels and their
plain PyTorch versions.

Source notes.

``confinement_cuda``
  Replaces ``fluid2d_tpu/ops/pallas_phases.py:confinement_pallas`` (core
  ``_confinement_core``). Kernel ``csrc/confinement.cu``
  ``confinement_fused_kernel``: one launch; a block copies u and w on a
  16×32 tile + 2 into shared-memory windows, computes the curl on the tile
  + 1 into a third (each entry at its clamped cell: the jnp path's
  clamp-of-computed), then the gradient of |curl|, the force and the update
  on the tile. Bound: bytes — reads v, v_alt (only at non-fluid cells) and
  fluid8, writes one (2, X, Y) plane pair, ~30 flops per cell. What the
  design does about it: the curl stays in shared memory (the two-launch
  design wrote it and its magnitude to two float planes and read them
  back), and the operands arrive in aligned 16-byte chunks. At float32 it
  runs as fast as the no-op twin of its operands (probe C3, PERF.md §6); at
  bf16 its fills go through registers and it is no faster than at float32.

``cip_velocity_phase_cuda``
  Replaces ``pallas_phases.py:cip_velocity_phase_pallas`` (body
  ``_cip_velocity_body``; advection ``pallas_stencil.py:768-910``).
  Kernel ``csrc/cip_phases.cu`` ``cip_velocity_fused_kernel`` (+
  ``csrc/cip_advect.cuh``, ``csrc/bc.cuh``): one launch; a block runs the
  BC, non-advection, gradient update and advection of both channels on a
  32×32 tile, each stage's values in a shared-memory window (tile + 3, + 2,
  + 1), the halo recomputed per tile.
  Bound: bytes — 11 operands read (the alternates only at wall cells) and
  six (2, X, Y) planes written, ~150 flops per cell and channel. What the
  fused design does about it: no stage result goes through device memory; a
  block copies its operands into its windows in aligned 16-byte chunks
  (``cp.async`` at float32, all in flight at once; 8-byte loads at bf16),
  the halo rows a neighbouring tile also reads come from L2, and the stages
  run from shared memory. What bounds it now: not the bytes — bf16, which
  halves them, saves 3–6%, and 16-byte bf16 copies or vector stores of 2–4
  cells a thread saved nothing (the latter cost registers, and so blocks
  an SM; PERF.md §6); a block's fill, stages and stores run one after
  another, with 5–6 blocks an SM to overlap them.

``cip_dye_phase_cuda``
  Replaces ``pallas_phases.py:cip_dye_phase_pallas`` (body
  ``_cip_dye_body``). Kernel ``cip_dye_fused_kernel``: the same cascade on
  a 32×32 tile of one dye channel (``blockIdx.z``), advected by the
  limited velocity (copied into a window too), value clamped to [0, 1].
  Bound: bytes, as the velocity phase; the same design. Each of the three
  channel blocks of a tile copies the velocity and the masks again (from
  L2); one block for all three channels kept too many loop-invariant values
  in registers (PERF.md §6).

``mac_velocity_phase_cuda``
  Replaces ``pallas_phases.py:mac_velocity_phase_pallas`` (core
  ``_mac_velocity_core``). Kernel ``csrc/mac_phases.cu``
  ``mac_velocity_fused_kernel``: one launch; a block copies both velocity
  channels of a 32×32 tile + 3 (upwind) or + 4 (KK) and the pressure on the
  tile + 1 into float windows, applies the velocity BC on the tile + 1 or
  + 2 at each entry's clamped cell (in place at the cells with a code,
  every entry evaluated before any is stored), then runs the upwind or KK
  momentum update on the tile at fluid cells and takes the old alternate
  elsewhere. Bound: bytes — reads v, p and two int8 planes,
  v_alt and bc_const at the cells that need them, writes two (2, X, Y)
  outputs, ~40 (upwind) to ~60 (KK) flops per cell and channel. What the
  design does about it: the BC'd field is not written and read back (the
  two-launch design did, through a float scratch plane at bf16), the
  operands arrive in aligned 16-byte chunks and the outputs leave as 4-cell
  vector stores.

``mac_dye_phase_cuda``
  Replaces ``pallas_phases.py:mac_dye_phase_pallas``. Kernel
  ``csrc/mac_phases.cu`` ``mac_dye_fused_kernel``: one launch; a block
  copies every dye channel of a 32×32 tile + 1 (upwind) or + 2 (KK) into
  float windows, applies the inflow BC in place at each entry's clamped
  cell, then advects by the limited velocity at fluid cells (the velocity
  read at the tile's cells, once for every channel), takes the old
  alternate elsewhere and clamps to [0, 1]. Bound: bytes, ~15–30 flops per
  cell and channel. What the design does about it: the BC'd dye is not
  written and read back (the two-launch design did, through a float
  scratch plane at bf16), the velocity and masks are read once a tile, the
  dye arrives in aligned 16-byte chunks and the outputs leave as 4-cell
  vector stores.

Storage. The state's planes, the scene's ``bc_const`` / ``bc_dye`` and the
outputs are float32 or bfloat16, one dtype per call (the transport dtype);
arithmetic is float32 and each output is rounded once, where the plain
version's ``.to(sd)`` rounds it. A stage result that a later stage reads
stays float32 (the fused kernels' shared-memory windows,
``csrc/common.cuh``), so the bf16 kernels are bit-identical to the plain
versions wherever the float32 ones are. Each C entry point takes a storage
flag.

Each wrapper takes CPU tensors to its plain version and launches its
kernel on CUDA tensors; there is no other path. Each declares its kernel
call once, a ``KernelCall``, which ``ops/launch.py:run`` reads for the
checks, the byte ledger and the launch. Each takes an optional
``out=``, the tensors it writes, in the order it returns them: a kernel
writes into them (the plain version's results are copied in), and an
output that shares a byte with an input raises, since the kernels read
their inputs through restrict pointers. Without it the outputs are fresh
tensors. Each runs inside the span
``f2d.phase.<name>`` (``utils/trace.py``), and ``ops/launch.py:launch``
counts its kernel runs. A MAC phase called with KK runs inside
``f2d.phase.<name>.kk`` and is counted under ``<entry>.kk``, so the KK
forms of B2 and B3 read apart from upwind's.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.advection import advect_kk, advect_upwind
from fluid2d_tpu_torch.ops.cip import (
    cip_advect,
    diff2_sum,
    non_advection_diffusion,
    non_advection_grad,
    non_advection_velocity,
)
from fluid2d_tpu_torch.ops.launch import KernelCall, bf16_storage, on_cpu, recip32, run
from fluid2d_tpu_torch.ops.limiters import clamp_field
from fluid2d_tpu_torch.ops.stencil import diff_x, diff_y
from fluid2d_tpu_torch.ops.vorticity import apply_confinement
from fluid2d_tpu_torch.scenes.runtime_bc import dye_bc, velocity_bc
from fluid2d_tpu_torch.utils.dtypes import f32
from fluid2d_tpu_torch.utils.trace import span

__all__ = [
    "confinement_cuda",
    "confinement_plain",
    "cip_velocity_phase_cuda",
    "cip_velocity_phase_plain",
    "cip_dye_phase_cuda",
    "cip_dye_phase_plain",
    "mac_velocity_phase_cuda",
    "mac_velocity_phase_plain",
    "mac_dye_phase_cuda",
    "mac_dye_phase_plain",
]


# --- vorticity confinement --------------------------------------------------


def confinement_plain(v, v_alt, fluid8, dt: float, weight: float, dx: float):
    """Confinement composed from the eager ops as
    ``fluid2d_tpu/models/common.py:237-242`` composes them. Returns
    ``(v_new, v)``: the alternate is the input, passed through."""
    vn, _ = apply_confinement(f32(v), f32(v_alt), fluid8 != 0, dt, weight, dx)
    return vn.to(v.dtype), v


def confinement_cuda(v, v_alt, fluid8, dt: float, weight: float, dx: float, *, out=None):
    """Vorticity confinement plus swap: ``v + dt·ε·f`` at fluid cells,
    ``v_alt`` elsewhere; the new alternate is the input `v` (no copy), so
    `out` is one tensor, the new velocity."""
    with span("f2d.phase.confinement"):
        wrapper, sd = "confinement_cuda", v.dtype
        _, x_rows, y_cols = v.shape
        vec, plane = (2, x_rows, y_cols), (x_rows, y_cols)
        call = KernelCall(
            wrapper, "confinement", "f2d_confinement",
            [("v", v, vec, sd), ("v_alt", v_alt, vec, sd), ("fluid8", fluid8, plane, torch.int8)],
            [(vec, sd)],
            (x_rows, y_cols, bf16_storage(wrapper, sd), recip32(dx), dt * weight))
        (v_out,) = run(call, out, on_cpu(v, wrapper),
                       lambda: confinement_plain(v, v_alt, fluid8, dt, weight, dx)[:1])
        return v_out, v


# --- CIP phases ---------------------------------------------------------------


def _int8_planes(scene, plane, *names: str) -> list:
    """The declared inputs of the scene's int8 planes `names`, in order."""
    return [(f"scene.{n}", getattr(scene, n), plane, torch.int8) for n in names]


def _cip_constants(re: float, dt: float, dx: float) -> tuple[float, ...]:
    """The grid constants of ``csrc/cip_advect.cuh:CipConsts``, in order,
    rounded as the eager path rounds them."""
    return (dt, dx, dx**2, dx**3, recip32(dx), recip32(dx**2), recip32(re), recip32(2.0 * dx))


def _advect_phase(f_na, gx_na, gy_na, vel, alt_f, alt_gx, alt_gy, fluid, dt, dx):
    """CIP advection at fluid cells, the kept values elsewhere
    (``fluid2d_tpu/models/cip.py:43-52``)."""
    f_cand, gx_cand, gy_cand = cip_advect(f_na, gx_na, gy_na, vel[0], vel[1], dt, dx)
    return (
        torch.where(fluid, f_cand, alt_f),
        torch.where(fluid, gx_cand, alt_gx),
        torch.where(fluid, gy_cand, alt_gy),
    )


def cip_velocity_phase_plain(v, p, v_alt, vx, vx_alt, vy, vy_alt, scene,
                             re: float, dt: float, dx: float):
    """The velocity phase composed from the eager ops, as the jnp branch
    of ``fluid2d_tpu/models/cip.py:76-100``. Returns
    ``(v_cur, vx_cur, vy_cur, v_na, vx_na, vy_na)``."""
    nw = scene.not_wall
    sd = v.dtype
    vc = velocity_bc(f32(v), scene)
    v_na = torch.where(nw, non_advection_velocity(vc, f32(p), re, dt, dx), f32(v_alt))
    gx_cand, gy_cand = non_advection_grad(f32(vx), f32(vy), vc, v_na, dx)
    vx_na = torch.where(nw, gx_cand, f32(vx_alt))
    vy_na = torch.where(nw, gy_cand, f32(vy_alt))
    v_cur, vx_cur, vy_cur = _advect_phase(
        v_na, vx_na, vy_na, v_na, vc, f32(vx), f32(vy), scene.fluid, dt, dx
    )
    return tuple(a.to(sd) for a in (v_cur, vx_cur, vy_cur, v_na, vx_na, vy_na))


def cip_velocity_phase_cuda(v, p, v_alt, vx, vx_alt, vy, vy_alt, scene,
                            re: float, dt: float, dx: float, *, out=None):
    """Whole CIP velocity phase: BC, non-advection, gradient update, CIP
    advection. Returns ``(v_cur, vx_cur, vy_cur, v_na, vx_na, vy_na)``, or
    `out` (six tensors shaped as v) holding them; the last three become
    the alternate buffers."""
    with span("f2d.phase.cip_velocity"):
        wrapper, sd = "cip_velocity_phase_cuda", v.dtype
        _, x_rows, y_cols = v.shape
        vec, plane = (2, x_rows, y_cols), (x_rows, y_cols)
        call = KernelCall(
            wrapper, "cip_velocity_phase", "f2d_cip_velocity_phase",
            [("v", v, vec, sd), ("p", p, plane, sd), ("v_alt", v_alt, vec, sd),
             ("vx", vx, vec, sd), ("vx_alt", vx_alt, vec, sd), ("vy", vy, vec, sd),
             ("vy_alt", vy_alt, vec, sd), ("scene.bc_const", scene.bc_const, vec, sd),
             *_int8_planes(scene, plane, "vbc_code", "not_wall8", "fluid8")],
            [(vec, sd)] * 6,
            (x_rows, y_cols, bf16_storage(wrapper, sd), *_cip_constants(re, dt, dx)))
        return run(call, out, on_cpu(v, wrapper), lambda: cip_velocity_phase_plain(
            v, p, v_alt, vx, vx_alt, vy, vy_alt, scene, re, dt, dx))


def cip_dye_phase_plain(dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, vel, scene,
                        re: float, dt: float, dx: float):
    """The dye phase composed from the eager ops, as the jnp branch of
    ``fluid2d_tpu/models/cip.py:132-150``. Returns
    ``(dye_cur, dyex_cur, dyey_cur, d_na, dx_na, dy_na)``."""
    nw = scene.not_wall
    sd = dye.dtype
    dc = dye_bc(f32(dye), scene)
    d_na = torch.where(nw, non_advection_diffusion(dc, re, dt, dx), f32(dye_alt))
    dgx_cand, dgy_cand = non_advection_grad(f32(dyex), f32(dyey), dc, d_na, dx)
    dx_na = torch.where(nw, dgx_cand, f32(dyex_alt))
    dy_na = torch.where(nw, dgy_cand, f32(dyey_alt))
    dye_adv, dyex_cur, dyey_cur = _advect_phase(
        d_na, dx_na, dy_na, f32(vel), dc, f32(dyex), f32(dyey), scene.fluid, dt, dx
    )
    dye_cur = clamp_field(dye_adv, 0.0, 1.0)
    return tuple(a.to(sd) for a in (dye_cur, dyex_cur, dyey_cur, d_na, dx_na, dy_na))


def cip_dye_phase_cuda(dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, vel, scene,
                       re: float, dt: float, dx: float, *, out=None):
    """Whole CIP dye phase: inflow BC, diffusion, gradient update, CIP
    advection by `vel` (the limited velocity), [0, 1] clamp. Returns
    ``(dye_cur, dyex_cur, dyey_cur, d_na, dx_na, dy_na)``, or `out` (six
    tensors shaped as dye) holding them."""
    with span("f2d.phase.cip_dye"):
        wrapper, sd = "cip_dye_phase_cuda", dye.dtype
        chans, x_rows, y_cols = dye.shape
        dyes, vec, plane = (chans, x_rows, y_cols), (2, x_rows, y_cols), (x_rows, y_cols)
        call = KernelCall(
            wrapper, "cip_dye_phase", "f2d_cip_dye_phase",
            [("dye", dye, dyes, sd), ("dye_alt", dye_alt, dyes, sd), ("dyex", dyex, dyes, sd),
             ("dyex_alt", dyex_alt, dyes, sd), ("dyey", dyey, dyes, sd),
             ("dyey_alt", dyey_alt, dyes, sd), ("vel", vel, vec, sd),
             ("scene.bc_dye", scene.bc_dye, dyes, sd),
             *_int8_planes(scene, plane, "inflow8", "not_wall8", "fluid8")],
            [(dyes, sd)] * 6,
            (x_rows, y_cols, chans, bf16_storage(wrapper, sd), *_cip_constants(re, dt, dx)))
        return run(call, out, on_cpu(dye, wrapper), lambda: cip_dye_phase_plain(
            dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, vel, scene, re, dt, dx))


# --- MAC phases -----------------------------------------------------------------

_ADVECT = {"upwind": advect_upwind, "kk": advect_kk}


def _mac_names(phase: str, scheme: str) -> tuple[str, str]:
    """The span and the launch-counter key of MAC phase `phase` under
    `scheme`, both from one form: KK's are counted apart
    (``f2d.phase.mac_velocity.kk``, ``f2d_mac_velocity_phase.kk``), upwind's
    keep the plain names."""
    form = ".kk" if scheme == "kk" else ""
    return f"f2d.phase.mac_{phase}{form}", f"f2d_mac_{phase}_phase{form}"


def _advect_fn(scheme: str):
    if scheme not in _ADVECT:
        msg = f"MAC phases take scheme 'upwind' or 'kk', not {scheme!r}"
        raise ValueError(msg)
    return _ADVECT[scheme]


def _inv_adv(scheme: str, dx: float) -> float:
    """The divisor of the scheme's differences as the eager path rounds it:
    1/dx (upwind) or 1/(6·dx) (KK)."""
    return recip32(6.0 * dx) if scheme == "kk" else recip32(dx)


def mac_velocity_phase_plain(v, p, v_alt, scene, scheme: str, re: float, dt: float, dx: float):
    """The velocity phase composed from the eager ops, as the jnp branch
    of ``fluid2d_tpu/models/mac.py:66-74``. Returns ``(v_cur, vc)``: the
    updated velocity (fluid cells; `v_alt` elsewhere) and the BC'd input,
    the new alternate."""
    advect = _advect_fn(scheme)
    sd = v.dtype
    vc = velocity_bc(f32(v), scene)
    p32 = f32(p)
    rhs = (
        -advect(vc[0], vc[1], vc, dx)
        - torch.stack([diff_x(p32, dx), diff_y(p32, dx)])
        + diff2_sum(vc, dx) / re
    )
    v_cur = torch.where(scene.fluid, vc + dt * rhs, f32(v_alt))
    return v_cur.to(sd), vc.to(sd)


def mac_velocity_phase_cuda(v, p, v_alt, scene, scheme: str, re: float, dt: float, dx: float, *,
                            out=None):
    """Whole MAC velocity phase: velocity BC, then the upwind or KK
    momentum update at fluid cells. Returns ``(v_cur, vc)``, or `out` (two
    tensors shaped as v) holding them."""
    span_name, entry = _mac_names("velocity", scheme)
    with span(span_name):
        _advect_fn(scheme)
        wrapper, sd = "mac_velocity_phase_cuda", v.dtype
        _, x_rows, y_cols = v.shape
        vec, plane = (2, x_rows, y_cols), (x_rows, y_cols)
        call = KernelCall(
            wrapper, f"mac_velocity_phase_{scheme}", entry,
            [("v", v, vec, sd), ("p", p, plane, sd), ("v_alt", v_alt, vec, sd),
             ("scene.bc_const", scene.bc_const, vec, sd),
             *_int8_planes(scene, plane, "vbc_code", "fluid8")],
            [(vec, sd)] * 2,
            (x_rows, y_cols, int(scheme == "kk"), bf16_storage(wrapper, sd), dt, recip32(dx),
             _inv_adv(scheme, dx), recip32(dx**2), recip32(re)))
        return run(call, out, on_cpu(v, wrapper),
                   lambda: mac_velocity_phase_plain(v, p, v_alt, scene, scheme, re, dt, dx))


def mac_dye_phase_plain(dye, dye_alt, vel, scene, scheme: str, dt: float, dx: float):
    """The dye phase composed from the eager ops, as the jnp branch of
    ``fluid2d_tpu/models/mac.py:98-105``. Returns ``(dye_cur, dc)``: the
    advected dye (fluid cells; `dye_alt` elsewhere) clamped to [0, 1], and
    the unclamped BC'd input, the new alternate."""
    advect = _advect_fn(scheme)
    sd = dye.dtype
    dc = dye_bc(f32(dye), scene)
    vel = f32(vel)
    dn = dc - dt * advect(vel[0], vel[1], dc, dx)
    dye_cur = clamp_field(torch.where(scene.fluid, dn, f32(dye_alt)), 0.0, 1.0)
    return dye_cur.to(sd), dc.to(sd)


def mac_dye_phase_cuda(dye, dye_alt, vel, scene, scheme: str, dt: float, dx: float, *, out=None):
    """Whole MAC dye phase: inflow BC, upwind or KK advection by `vel`
    (the limited velocity) at fluid cells, [0, 1] clamp. Returns
    ``(dye_cur, dc)``, or `out` (two tensors shaped as dye) holding them."""
    span_name, entry = _mac_names("dye", scheme)
    with span(span_name):
        _advect_fn(scheme)
        wrapper, sd = "mac_dye_phase_cuda", dye.dtype
        chans, x_rows, y_cols = dye.shape
        dyes, vec, plane = (chans, x_rows, y_cols), (2, x_rows, y_cols), (x_rows, y_cols)
        call = KernelCall(
            wrapper, f"mac_dye_phase_{scheme}", entry,
            [("dye", dye, dyes, sd), ("dye_alt", dye_alt, dyes, sd), ("vel", vel, vec, sd),
             ("scene.bc_dye", scene.bc_dye, dyes, sd),
             *_int8_planes(scene, plane, "inflow8", "fluid8")],
            [(dyes, sd)] * 2,
            (x_rows, y_cols, chans, int(scheme == "kk"), bf16_storage(wrapper, sd), dt,
             _inv_adv(scheme, dx)))
        return run(call, out, on_cpu(dye, wrapper),
                   lambda: mac_dye_phase_plain(dye, dye_alt, vel, scene, scheme, dt, dx))
