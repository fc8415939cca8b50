"""The seeded initial state of a run, made on the device from ``--seed``.

A run never starts from rest: from the zero state confinement's 0/0 rule
decides the first steps, which rounding then tips either way. The state is
a sum of smooth random modes (a handful of wave numbers on the grid, random
phases and amplitudes) at the fluid cells, with speeds well inside the
velocity limit; the dye lies in [0.1, 0.9]; the CIP gradient planes are the
fields' central differences; every alternate holds a copy of its field.
The same seed gives the same state; every seed gives the same shapes.
"""

from __future__ import annotations

import hashlib
import math

import torch

__all__ = ["seeded_state", "MODES"]

MODES = 4  # modes a field
_FIELDS = ("u", "w", "p", "d0", "d1", "d2")


def _generator(seed: int, device) -> torch.Generator:
    """A generator on `device` for any whole-number seed. The seed is hashed
    first: the CPU's generator keeps only the low 32 bits of its seed."""
    digest = hashlib.sha256(str(int(seed)).encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:4], "little"))


def _grad(f, dx: float):
    """Central differences in x and y, edges clamped."""
    def sh(a, d, dim):
        n = a.shape[dim]
        idx = torch.clamp(torch.arange(n, device=a.device) + d, 0, n - 1)
        return a.index_select(dim, idx)

    gx = 0.5 * (sh(f, 1, -2) - sh(f, -1, -2)) / dx
    gy = 0.5 * (sh(f, 1, -1) - sh(f, -1, -1)) / dx
    return gx, gy


def seeded_state(cfg: dict, fluid: torch.Tensor, seed: int, speed: float = 0.5) -> dict:
    """The initial state of configuration `cfg` (``scheme``, ``enable_dye``,
    ``dx``) on the grid of the bool mask `fluid` (X, Y), as float32 leaves
    named as the program's state, plus ``step``. Each velocity component
    is at most `speed` in magnitude, the pressure at most 0.1·`speed`."""
    dev = fluid.device
    x_res, y_res = fluid.shape
    g = _generator(seed, dev)
    n = len(_FIELDS)
    k = torch.randint(1, 5, (n, MODES, 2), generator=g, device=dev).float()
    phase = torch.rand((n, MODES, 2), generator=g, device=dev) * (2 * math.pi)
    amp = torch.rand((n, MODES), generator=g, device=dev) + 0.25
    amp = amp / amp.sum(dim=1, keepdim=True)  # |field| ≤ 1
    gx = torch.linspace(0, 2 * math.pi, x_res, device=dev)
    gy = torch.linspace(0, 2 * math.pi, y_res, device=dev)
    sx = torch.sin(k[..., 0, None] * gx + phase[..., 0, None])  # (n, M, X)
    cy = torch.cos(k[..., 1, None] * gy + phase[..., 1, None])  # (n, M, Y)
    # A sum over the modes, not a matrix product: no TF32, the same bits each time.
    fields = (amp[..., None, None] * sx[..., None] * cy[..., None, :]).sum(dim=1) * fluid
    s = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "v": speed * fields[0:2].contiguous(),
        "p": 0.1 * speed * fields[2].contiguous(),
    }
    if cfg["enable_dye"]:
        s["dye"] = (0.5 + 0.4 * fields[3:6]).contiguous()
    names = ["v", "p"] + (["dye"] if cfg["enable_dye"] else [])
    if cfg["scheme"] == "cip":
        for f in ("v", "dye") if cfg["enable_dye"] else ("v",):
            s[f + "x"], s[f + "y"] = _grad(s[f], cfg["dx"])
            names += [f + "x", f + "y"]
    for f in names:
        s[f + "_alt"] = s[f].clone()
    return s
