"""The plain reference step: the simulator of takah29/2d-fluid-simulator
(``fs/solver.py``, ``fs/pressure_updater.py``, ``fs/boundary_condition.py``,
``fs/vorticity_confinement.py``, ``fs/advection.py``) as whole-grid PyTorch
operations in float32, for the benchmark's check of what the timed path
produces.

The state is a dict of float32 tensors, fields channel-first (C, X, Y):
``v``, ``p`` and their alternates ``v_alt``, ``p_alt``; with CIP the
gradient planes ``vx``, ``vy`` and alternates; with dye ``dye``,
``dye_alt`` and with CIP ``dyex``, ``dyey`` and alternates. The alternates
are the reference's double buffers: masked updates leave a cell's older
value where the phase does not compute it, and the SOR even sweep reads
them. Reads past the grid clamp to the edge cell.
"""

from __future__ import annotations

import torch

__all__ = ["Reference"]


def _shift(f, d: int, dim: int):
    """out[k] = f[clamp(k + d)] along `dim`."""
    n = f.shape[dim]
    if d > 0:
        return torch.cat([f.narrow(dim, d, n - d), *[f.narrow(dim, n - 1, 1)] * d], dim)
    if d < 0:
        return torch.cat([*[f.narrow(dim, 0, 1)] * -d, f.narrow(dim, 0, n + d)], dim)
    return f


def sx(f, d: int):
    return _shift(f, d, f.dim() - 2)


def sy(f, d: int):
    return _shift(f, d, f.dim() - 1)


def dcx(f, dx):
    return 0.5 * (sx(f, 1) - sx(f, -1)) / dx


def dcy(f, dx):
    return 0.5 * (sy(f, 1) - sy(f, -1)) / dx


def lap(f, dx):
    return (sx(f, 1) - 2.0 * f + sx(f, -1)) / dx**2 + (sy(f, 1) - 2.0 * f + sy(f, -1)) / dx**2


def fmin(x, c: float):
    """min that returns c for NaN (Taichi's ti.min)."""
    return torch.fmin(x, x.new_full((), c))


def fmax(x, c: float):
    return torch.fmax(x, x.new_full((), c))


def upwind(u, w, f, dx):
    """First-order upwind (v·∇)f: the forward difference where the velocity
    is negative, the backward one otherwise."""
    ax = u * torch.where(u < 0.0, (sx(f, 1) - f) / dx, (f - sx(f, -1)) / dx)
    ay = w * torch.where(w < 0.0, (sy(f, 1) - f) / dx, (f - sy(f, -1)) / dx)
    return ax + ay


def kk(u, w, f, dx):
    """Kawamura-Kuwahara (v·∇)f, 5 points upwind-biased."""
    def axis(s, vel):
        p2, p1, m1, m2 = s(f, 2), s(f, 1), s(f, -1), s(f, -2)
        neg = -2.0 * p2 + 10.0 * p1 - 9.0 * f + 2.0 * m1 - 1.0 * m2
        pos = 1.0 * p2 - 2.0 * p1 + 9.0 * f - 10.0 * m1 + 2.0 * m2
        return torch.where(vel < 0.0, neg, pos) / (6.0 * dx)

    return u * axis(sx, u) + w * axis(sy, w)


def cip(f, fx, fy, u, w, dt, dx):
    """Cubic CIP advection of the triplet (f, ∂f/∂x, ∂f/∂y) by (u, w), with
    the gradient's stretching term; whole grid."""
    up_x, up_y = ~(u < 0.0), ~(w < 0.0)  # NaN takes the u ≥ 0 branch
    i_s = 1.0 - 2.0 * (u < 0.0).to(u.dtype)
    j_s = 1.0 - 2.0 * (w < 0.0).to(w.dtype)

    def back_x(a):
        return torch.where(up_x, sx(a, -1), sx(a, 1))

    def back_y(a):
        return torch.where(up_y, sy(a, -1), sy(a, 1))

    f_im, f_jm = back_x(f), back_y(f)
    f_imjm = torch.where(up_x, torch.where(up_y, sy(sx(f, -1), -1), sy(sx(f, -1), 1)),
                         torch.where(up_y, sy(sx(f, 1), -1), sy(sx(f, 1), 1)))
    fx_im, fx_jm, fy_im, fy_jm = back_x(fx), back_y(fx), back_x(fy), back_y(fy)

    t1 = f - f_jm - f_im + f_imjm
    t2 = f_im - f
    t3 = f_jm - f
    i_den, j_den = i_s * dx**3, j_s * dx**3
    a = (i_s * (fx_im + fx) * dx - 2.0 * (-t2)) / i_den
    b = (j_s * (fy_jm + fy) * dx - 2.0 * (-t3)) / j_den
    c = (-t1 - i_s * (fx_jm - fx) * dx) / j_den
    d = (-t1 - j_s * (fy_im - fy) * dx) / i_den
    e = (3.0 * t2 + i_s * (fx_im + 2.0 * fx) * dx) / dx**2
    g3 = (3.0 * t3 + j_s * (fy_jm + 2.0 * fy) * dx) / dx**2
    g = (-(fy_im - fy) + c * dx**2) / (i_s * dx)
    X, Y = -u * dt, -w * dt
    fn = ((a * X + c * Y + e) * X + g * Y + fx) * X + ((b * Y + d * X + g3) * Y + fy) * Y + f
    Fx = (3.0 * a * X + 2.0 * c * Y + 2.0 * e) * X + (d * Y + g) * Y + fx
    Fy = (3.0 * b * Y + 2.0 * d * X + 2.0 * g3) * Y + (c * X + g) * X + fy
    ux, wx, uy, wy = dcx(u, dx), dcx(w, dx), dcy(u, dx), dcy(w, dx)
    return fn, Fx - dt * (Fx * ux + Fy * wx) / 2.0, Fy - dt * (Fx * uy + Fy * wy) / 2.0


class Reference:
    """One configuration's plain step on one scene.

    `cfg` holds the simulator settings (``scheme`` upwind, kk or cip;
    ``re``, ``dt``, ``dx``, ``vor_eps`` or None, ``enable_dye``,
    ``pressure_solver`` sor or jacobi, ``sor_omega``, ``n_pressure_iter``,
    ``velocity_limit``); `scene` the arrays of :mod:`.scenes` (``mask``,
    ``bc``, ``dye`` and the derived masks)."""

    def __init__(self, cfg: dict, scene: dict, device):
        self.cfg = cfg
        t = {k: torch.as_tensor(a).to(device) for k, a in scene.items()}
        mask = t["mask"]
        self.fluid, self.wall, self.not_wall = mask == 0, mask == 1, mask != 1
        self.inflow, self.outflow = mask == 2, mask == 3
        self.bc, self.bc_dye, self.ghost, self.pcode = t["bc"], t["dye"], t["ghost"], t["pcode"]
        self.odd_fluid, self.even_fluid = t["odd_fluid"], t["even_fluid"]

    # -- boundary conditions -------------------------------------------------
    def velocity_bc(self, v):
        out = v
        for k, (di, dj) in enumerate(((-2, 0), (2, 0), (0, -2), (0, 2))):
            out = torch.where(self.ghost[k], -sy(sx(v, di), dj), out)
        out = torch.where(self.inflow, self.bc, out)
        u = torch.where(self.outflow, fmax(sx(v[0], -1), 0.05), out[0])
        return torch.stack([u, out[1]])

    def pressure_bc(self, p):
        code = self.pcode
        xm, xp, ym, yp = sx(p, -1), sx(p, 1), sy(p, -1), sy(p, 1)
        for k, val in enumerate((xm, xp, ym, yp, (xm + yp) / 2.0, (xp + yp) / 2.0,
                                 (xm + ym) / 2.0, (xp + ym) / 2.0, xp), start=1):
            p = torch.where(code == k, val, p)
        return torch.where(code == 10, 0.0, p)

    def dye_bc(self, d):
        return torch.where(self.inflow, self.bc_dye, d)

    # -- pressure ------------------------------------------------------------
    def predict_p(self, p, u, w):
        dt, dx = self.cfg["dt"], self.cfg["dx"]
        xu, xw = sx(u, 1) - sx(u, -1), sx(w, 1) - sx(w, -1)
        yu, yw = sy(u, 1) - sy(u, -1), sy(w, 1) - sy(w, -1)
        return (0.25 * (sx(p, 1) + sx(p, -1) + sy(p, 1) + sy(p, -1))
                + (xu * xu + yw * yw + (yu * xw)) / 8.0
                - dx * (xu + yw) / (8 * dt))

    def pressure(self, p, p_alt, v):
        """The configured iterations, each: the pressure BC on the current
        buffer, the sweeps into the alternate, a swap; then the velocity
        norm limited to ``velocity_limit``."""
        u, w = v[0], v[1]
        om = self.cfg["sor_omega"]
        for _ in range(self.cfg["n_pressure_iter"]):
            pc = self.pressure_bc(p)
            if self.cfg["pressure_solver"] == "jacobi":
                pn = torch.where(self.not_wall, self.predict_p(pc, u, w), p_alt)
            else:
                pn = torch.where(self.odd_fluid, (1.0 - om) * pc + om * self.predict_p(pc, u, w),
                                 p_alt)
                pn = torch.where(self.even_fluid, (1.0 - om) * pn + om * self.predict_p(pn, u, w),
                                 pn)
            p, p_alt = pn, pc
        norm = torch.sqrt(v[0] * v[0] + v[1] * v[1])
        lim = self.cfg["velocity_limit"]
        return p, p_alt, torch.where(norm > lim, lim * (v / norm), v)

    def confinement(self, v, v_alt):
        """Vorticity confinement; the unguarded 0/0 of a flat |ω| gives NaN,
        which the ±0.1 clamp turns into +0.1, as in the reference."""
        dx, eps, dt = self.cfg["dx"], self.cfg["vor_eps"], self.cfg["dt"]
        curl = dcx(v[1], dx) - dcy(v[0], dx)
        vort = torch.where(self.fluid, curl, 0.0)
        vabs = torch.where(self.fluid, torch.abs(curl), 0.0)
        gx, gy = dcx(vabs, dx), dcy(vabs, dx)
        norm = torch.sqrt(gx * gx + gy * gy)
        fx = fmax(fmin((gy / norm) * vort, 0.1), -0.1)
        fy = fmax(fmin(-(gx / norm) * vort, 0.1), -0.1)
        return torch.where(self.fluid, v + dt * eps * torch.stack([fx, fy]), v_alt), v

    # -- the step --------------------------------------------------------------
    def step(self, s: dict) -> dict:
        cfg = self.cfg
        re, dt, dx = cfg["re"], cfg["dt"], cfg["dx"]
        out = dict(s)
        out["step"] = s["step"] + 1
        if cfg["scheme"] == "cip":
            vc = self.velocity_bc(s["v"])
            grad_p = torch.stack([dcx(s["p"], dx), dcy(s["p"], dx)])
            v_na = torch.where(self.not_wall, vc + (-grad_p + lap(vc, dx) / re) * dt, s["v_alt"])
            vx_na, vy_na = self._grad_update(s["vx"], s["vy"], s["vx_alt"], s["vy_alt"], vc, v_na)
            v, vx, vy = self._advect(v_na, vx_na, vy_na, v_na, vc, s["vx"], s["vy"])
            v_alt = v_na
            out.update(vx=vx, vy=vy, vx_alt=vx_na, vy_alt=vy_na)
        else:
            adv = upwind if cfg["scheme"] == "upwind" else kk
            vc = self.velocity_bc(s["v"])
            p = s["p"]
            rhs = -adv(vc[0], vc[1], vc, dx) - torch.stack([dcx(p, dx), dcy(p, dx)]) \
                + lap(vc, dx) / re
            v, v_alt = torch.where(self.fluid, vc + dt * rhs, s["v_alt"]), vc
        if cfg["vor_eps"] is not None:
            v, v_alt = self.confinement(v, v_alt)
        out["p"], out["p_alt"], out["v"] = self.pressure(s["p"], s["p_alt"], v)
        out["v_alt"] = v_alt
        if cfg["enable_dye"]:
            vel = out["v"]
            dc = self.dye_bc(s["dye"])
            if cfg["scheme"] == "cip":
                d_na = torch.where(self.not_wall, dc + (lap(dc, dx) / re) * dt, s["dye_alt"])
                gx_na, gy_na = self._grad_update(s["dyex"], s["dyey"], s["dyex_alt"],
                                                 s["dyey_alt"], dc, d_na)
                d, gx, gy = self._advect(d_na, gx_na, gy_na, vel, dc, s["dyex"], s["dyey"])
                out.update(dye=fmin(fmax(d, 0.0), 1.0), dye_alt=d_na, dyex=gx, dyey=gy,
                           dyex_alt=gx_na, dyey_alt=gy_na)
            else:
                adv = upwind if cfg["scheme"] == "upwind" else kk
                dn = dc - dt * adv(vel[0], vel[1], dc, dx)
                out.update(dye=fmin(fmax(torch.where(self.fluid, dn, s["dye_alt"]), 0.0), 1.0),
                           dye_alt=dc)
        return out

    def run(self, s: dict, n: int) -> dict:
        for _ in range(n):
            s = self.step(s)
        return s

    def _grad_update(self, fx, fy, fx_alt, fy_alt, f_old, f_new):
        """CIP gradients moved by the non-advection change of f, at not-wall
        cells."""
        dx = self.cfg["dx"]
        delta = f_new - f_old
        gx = fx + (sx(delta, 1) - sx(delta, -1)) / (2.0 * dx)
        gy = fy + (sy(delta, 1) - sy(delta, -1)) / (2.0 * dx)
        return torch.where(self.not_wall, gx, fx_alt), torch.where(self.not_wall, gy, fy_alt)

    def _advect(self, f, fx, fy, vel, keep_f, keep_fx, keep_fy):
        """CIP advection at fluid cells; elsewhere the kept values."""
        fn, gx, gy = cip(f, fx, fy, vel[0], vel[1], self.cfg["dt"], self.cfg["dx"])
        return (torch.where(self.fluid, fn, keep_f), torch.where(self.fluid, gx, keep_fx),
                torch.where(self.fluid, gy, keep_fy))
