"""Whole-phase kernels of the CIP and MAC steps: the CUDA kernels and their
plain PyTorch versions.

Source notes.

``confinement_cuda``
  Replaces ``fluid2d_tpu/ops/pallas_phases.py:confinement_pallas`` (core
  ``_confinement_core``). Kernel ``csrc/confinement.cu``: two launches,
  curl (+|curl|) into scratch, then force and update.
  Bound: bytes — reads v, v_alt, fluid8 and the two scratch planes,
  writes two planes, ~30 flops per cell.

``cip_velocity_phase_cuda``
  Replaces ``pallas_phases.py:cip_velocity_phase_pallas`` (body
  ``_cip_velocity_body``; advection ``pallas_stencil.py:768-910``).
  Kernel ``csrc/cip_phases.cu`` + ``csrc/cip_advect.cuh``: four launches
  (BC, non-advection, gradient update, advection) over both channels.
  Bound: bytes — about 16 planes read and 14 written per channel pair
  across the four launches, ~120 flops per cell in the advection.

``cip_dye_phase_cuda``
  Replaces ``pallas_phases.py:cip_dye_phase_pallas`` (body
  ``_cip_dye_body``). Same four launches over three channels, advected by
  the limited velocity, value clamped to [0, 1].
  Bound: bytes, as the velocity phase.

``mac_velocity_phase_cuda``
  Replaces ``pallas_phases.py:mac_velocity_phase_pallas`` (core
  ``_mac_velocity_core``). Kernel ``csrc/mac_phases.cu``: two launches,
  velocity BC (the new alternate, an output), then the upwind or KK
  momentum update at fluid cells reading the BC'd field with clamped
  indices. Bound: bytes — reads v, v_alt, bc_const, p and two int8 planes,
  writes two (2, X, Y) outputs, ~40 (upwind) to ~60 (KK) flops per cell.

``mac_dye_phase_cuda``
  Replaces ``pallas_phases.py:mac_dye_phase_pallas``. Same two launches on
  the 3 dye channels: inflow BC (the new alternate), then upwind or KK
  advection by the limited velocity at fluid cells and the [0, 1] clamp.
  Bound: bytes, ~15–30 flops per cell and channel.

What the simple design does about the bound: nothing yet. One thread per
cell, ``threadIdx.x`` along the contiguous Y axis (coalesced), neighbours
read from global memory with clamp-to-edge index math, every stage's
result written to device memory and read back by the next launch. Tiles
in shared memory and stage fusion are later work.

Storage. The state's planes, the scene's ``bc_const`` / ``bc_dye`` and the
outputs are float32 or bfloat16, one dtype per call (the transport dtype);
arithmetic is float32 and each output is rounded once, where the plain
version's ``.to(sd)`` rounds it. A stage result that a later launch reads
stays float32 (scratch at bf16, ``csrc/common.cuh``), so the bf16 kernels
are bit-identical to the plain versions wherever the float32 ones are.

Each wrapper takes CPU tensors to its plain version and launches its
kernel on CUDA tensors; there is no other path. ``<wrapper>.launches``
counts kernel runs.
"""

from __future__ import annotations

import torch

from fluid2d_tpu_torch.ops.advection import advect_kk, advect_upwind
from fluid2d_tpu_torch.ops import launch as _launch
from fluid2d_tpu_torch.ops.cip import (
    cip_advect,
    diff2_sum,
    non_advection_diffusion,
    non_advection_grad,
    non_advection_velocity,
)
from fluid2d_tpu_torch.ops.launch import (
    entry,
    launch,
    log_traffic,
    on_cpu,
    operand_bytes,
    recip32,
    require,
)
from fluid2d_tpu_torch.ops.limiters import clamp_field
from fluid2d_tpu_torch.ops.stencil import diff_x, diff_y
from fluid2d_tpu_torch.ops.vorticity import apply_confinement
from fluid2d_tpu_torch.scenes.runtime_bc import dye_bc, velocity_bc
from fluid2d_tpu_torch.utils.dtypes import f32

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


def confinement_cuda(v, v_alt, fluid8, dt: float, weight: float, dx: float):
    """Vorticity confinement plus swap: ``v + dt·ε·f`` at fluid cells,
    ``v_alt`` elsewhere; the new alternate is the input `v` (no copy)."""
    if _launch.TRAFFIC_LOG is not None:
        log_traffic("confinement", operand_bytes(v, v_alt, fluid8) + operand_bytes(v))
    if on_cpu(v, "confinement_cuda"):
        return confinement_plain(v, v_alt, fluid8, dt, weight, dx)
    dev, sd = v.device, v.dtype
    _, x_rows, y_cols = v.shape
    vec, plane = (2, x_rows, y_cols), (x_rows, y_cols)
    name = entry("f2d_confinement", sd)
    ptrs = [
        require(v, "v", vec, sd, dev),
        require(v_alt, "v_alt", vec, sd, dev),
        require(fluid8, "fluid8", plane, torch.int8, dev),
    ]
    vort = torch.empty(plane, dtype=torch.float32, device=dev)
    vort_abs = torch.empty_like(vort)
    v_out = torch.empty_like(v)
    launch(name, dev, *ptrs, vort.data_ptr(), vort_abs.data_ptr(),
           v_out.data_ptr(), x_rows, y_cols, recip32(dx), dt * weight)
    confinement_cuda.launches += 1
    return v_out, v


confinement_cuda.launches = 0


# --- CIP phases ---------------------------------------------------------------


def _cip_constants(re: float, dt: float, dx: float) -> tuple[float, ...]:
    """The grid constants of ``csrc/cip_advect.cuh:CipConsts``, in order,
    rounded as the eager path rounds them."""
    return (dt, dx, dx**2, dx**3, recip32(dx), recip32(dx**2), recip32(re), recip32(2.0 * dx))


def _wide_scratch(shape, sd, dev, n: int) -> list[torch.Tensor]:
    """The `n` float planes a bf16 phase keeps beside its rounded outputs
    for its later launches to read (none at float32, where the outputs are
    those planes). The caller holds them until the launch is queued."""
    if sd == torch.float32:
        return []
    return [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(n)]


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
                            re: float, dt: float, dx: float):
    """Whole CIP velocity phase: BC, non-advection, gradient update, CIP
    advection. Returns ``(v_cur, vx_cur, vy_cur, v_na, vx_na, vy_na)``;
    the last three become the alternate buffers."""
    if _launch.TRAFFIC_LOG is not None:
        log_traffic("cip_velocity_phase",
                    operand_bytes(v, p, v_alt, vx, vx_alt, vy, vy_alt, scene.bc_const,
                                  scene.vbc_code, scene.not_wall8, scene.fluid8)
                    + 6 * operand_bytes(v))
    if on_cpu(v, "cip_velocity_phase_cuda"):
        return cip_velocity_phase_plain(v, p, v_alt, vx, vx_alt, vy, vy_alt, scene, re, dt, dx)
    dev, sd = v.device, v.dtype
    _, x_rows, y_cols = v.shape
    vec, plane = (2, x_rows, y_cols), (x_rows, y_cols)
    name, i8 = entry("f2d_cip_velocity_phase", sd), torch.int8
    ptrs = [
        require(v, "v", vec, sd, dev),
        require(p, "p", plane, sd, dev),
        require(v_alt, "v_alt", vec, sd, dev),
        require(vx, "vx", vec, sd, dev),
        require(vx_alt, "vx_alt", vec, sd, dev),
        require(vy, "vy", vec, sd, dev),
        require(vy_alt, "vy_alt", vec, sd, dev),
        require(scene.bc_const, "scene.bc_const", vec, sd, dev),
        require(scene.vbc_code, "scene.vbc_code", plane, i8, dev),
        require(scene.not_wall8, "scene.not_wall8", plane, i8, dev),
        require(scene.fluid8, "scene.fluid8", plane, i8, dev),
    ]
    v_bc = torch.empty(vec, dtype=torch.float32, device=dev)
    outs = tuple(torch.empty_like(v) for _ in range(6))
    na32 = _wide_scratch(vec, sd, dev, 3)
    launch(name, dev, *ptrs, v_bc.data_ptr(), *(o.data_ptr() for o in outs),
           *(t.data_ptr() for t in na32), x_rows, y_cols, *_cip_constants(re, dt, dx))
    cip_velocity_phase_cuda.launches += 1
    return outs


cip_velocity_phase_cuda.launches = 0


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
                       re: float, dt: float, dx: float):
    """Whole CIP dye phase: inflow BC, diffusion, gradient update, CIP
    advection by `vel` (the limited velocity), [0, 1] clamp. Returns
    ``(dye_cur, dyex_cur, dyey_cur, d_na, dx_na, dy_na)``."""
    if _launch.TRAFFIC_LOG is not None:
        log_traffic("cip_dye_phase",
                    operand_bytes(dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, vel, scene.bc_dye,
                                  scene.inflow8, scene.not_wall8, scene.fluid8)
                    + 6 * operand_bytes(dye))
    if on_cpu(dye, "cip_dye_phase_cuda"):
        return cip_dye_phase_plain(dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, vel, scene,
                                   re, dt, dx)
    dev, sd = dye.device, dye.dtype
    _, x_rows, y_cols = dye.shape
    dyes, vec, plane = (3, x_rows, y_cols), (2, x_rows, y_cols), (x_rows, y_cols)
    name, i8 = entry("f2d_cip_dye_phase", sd), torch.int8
    ptrs = [
        require(dye, "dye", dyes, sd, dev),
        require(dye_alt, "dye_alt", dyes, sd, dev),
        require(dyex, "dyex", dyes, sd, dev),
        require(dyex_alt, "dyex_alt", dyes, sd, dev),
        require(dyey, "dyey", dyes, sd, dev),
        require(dyey_alt, "dyey_alt", dyes, sd, dev),
        require(vel, "vel", vec, sd, dev),
        require(scene.bc_dye, "scene.bc_dye", dyes, sd, dev),
        require(scene.inflow8, "scene.inflow8", plane, i8, dev),
        require(scene.not_wall8, "scene.not_wall8", plane, i8, dev),
        require(scene.fluid8, "scene.fluid8", plane, i8, dev),
    ]
    d_bc = torch.empty(dyes, dtype=torch.float32, device=dev)
    outs = tuple(torch.empty_like(dye) for _ in range(6))
    na32 = _wide_scratch(dyes, sd, dev, 3)
    launch(name, dev, *ptrs, d_bc.data_ptr(), *(o.data_ptr() for o in outs),
           *(t.data_ptr() for t in na32), x_rows, y_cols, *_cip_constants(re, dt, dx))
    cip_dye_phase_cuda.launches += 1
    return outs


cip_dye_phase_cuda.launches = 0


# --- MAC phases -----------------------------------------------------------------

_ADVECT = {"upwind": advect_upwind, "kk": advect_kk}


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


def mac_velocity_phase_cuda(v, p, v_alt, scene, scheme: str, re: float, dt: float, dx: float):
    """Whole MAC velocity phase: velocity BC, then the upwind or KK
    momentum update at fluid cells. Returns ``(v_cur, vc)``."""
    _advect_fn(scheme)
    if _launch.TRAFFIC_LOG is not None:
        log_traffic(f"mac_velocity_phase_{scheme}",
                    operand_bytes(v, p, v_alt, scene.bc_const, scene.vbc_code, scene.fluid8)
                    + 2 * operand_bytes(v))
    if on_cpu(v, "mac_velocity_phase_cuda"):
        return mac_velocity_phase_plain(v, p, v_alt, scene, scheme, re, dt, dx)
    dev, sd = v.device, v.dtype
    _, x_rows, y_cols = v.shape
    vec, plane = (2, x_rows, y_cols), (x_rows, y_cols)
    name, i8 = entry("f2d_mac_velocity_phase", sd), torch.int8
    ptrs = [
        require(v, "v", vec, sd, dev),
        require(p, "p", plane, sd, dev),
        require(v_alt, "v_alt", vec, sd, dev),
        require(scene.bc_const, "scene.bc_const", vec, sd, dev),
        require(scene.vbc_code, "scene.vbc_code", plane, i8, dev),
        require(scene.fluid8, "scene.fluid8", plane, i8, dev),
    ]
    v_out = torch.empty_like(v)
    v_bc = torch.empty_like(v)
    bc32 = _wide_scratch(vec, sd, dev, 1)
    launch(name, dev, *ptrs, v_out.data_ptr(), v_bc.data_ptr(), *(t.data_ptr() for t in bc32),
           x_rows, y_cols, int(scheme == "kk"), dt, recip32(dx), _inv_adv(scheme, dx),
           recip32(dx**2), recip32(re))
    mac_velocity_phase_cuda.launches += 1
    return v_out, v_bc


mac_velocity_phase_cuda.launches = 0


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


def mac_dye_phase_cuda(dye, dye_alt, vel, scene, scheme: str, dt: float, dx: float):
    """Whole MAC dye phase: inflow BC, upwind or KK advection by `vel`
    (the limited velocity) at fluid cells, [0, 1] clamp. Returns
    ``(dye_cur, dc)``."""
    _advect_fn(scheme)
    if _launch.TRAFFIC_LOG is not None:
        log_traffic(f"mac_dye_phase_{scheme}",
                    operand_bytes(dye, dye_alt, vel, scene.bc_dye, scene.inflow8, scene.fluid8)
                    + 2 * operand_bytes(dye))
    if on_cpu(dye, "mac_dye_phase_cuda"):
        return mac_dye_phase_plain(dye, dye_alt, vel, scene, scheme, dt, dx)
    dev, sd = dye.device, dye.dtype
    chans, x_rows, y_cols = dye.shape
    dyes, vec, plane = (chans, x_rows, y_cols), (2, x_rows, y_cols), (x_rows, y_cols)
    name, i8 = entry("f2d_mac_dye_phase", sd), torch.int8
    ptrs = [
        require(dye, "dye", dyes, sd, dev),
        require(dye_alt, "dye_alt", dyes, sd, dev),
        require(vel, "vel", vec, sd, dev),
        require(scene.bc_dye, "scene.bc_dye", dyes, sd, dev),
        require(scene.inflow8, "scene.inflow8", plane, i8, dev),
        require(scene.fluid8, "scene.fluid8", plane, i8, dev),
    ]
    d_out = torch.empty_like(dye)
    d_bc = torch.empty_like(dye)
    bc32 = _wide_scratch(dyes, sd, dev, 1)
    launch(name, dev, *ptrs, d_out.data_ptr(), d_bc.data_ptr(), *(t.data_ptr() for t in bc32),
           x_rows, y_cols, chans, int(scheme == "kk"), dt, _inv_adv(scheme, dx))
    mac_dye_phase_cuda.launches += 1
    return d_out, d_bc


mac_dye_phase_cuda.launches = 0
