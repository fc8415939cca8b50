"""The least time one step can take on the card: its bytes at the published
HBM rate, or its element operations at the published float32 rate,
whichever is larger.

Both counts come from the configuration and the scene's mask alone, never
from the program: the share stays the same whatever kernels implement the
step, and fusing phases raises it honestly.

Bytes: every state leaf the step writes, written once, plus every leaf and
scene plane it reads, read once, and a leaf that a step reads only where
some output depends on it (an alternate buffer, an imposed value) counted
at those cells alone. The scene is one byte a cell (the mask, from which
every boundary code follows) plus the imposed inflow velocity and dye at
the inflow cells.

Element operations: the aten operations of the plain reference step
(:mod:`bench_port.reference.step`), run on shape-only tensors and weighted
as the program's own counter weighs them (division and the transcendental
operations 3, sign 2, the rest 1; views, copies, indexing, concatenation
and creation free; a reduction counts its input).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS_PER_S", "step_bytes", "step_elops", "least_step_s"]

# One H100 SXM, NVIDIA's data sheet: HBM3 bandwidth, and float32 outside the
# tensor cores (at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def _cells(mask: np.ndarray) -> dict[str, int]:
    fluid = mask == 0
    odd = (np.add.outer(np.arange(mask.shape[0]), np.arange(mask.shape[1])) % 2) == 1
    return {"all": mask.size, "wall": int((mask == 1).sum()), "not_fluid": int((~fluid).sum()),
            "inflow": int((mask == 2).sum()), "not_odd_fluid": int((~(fluid & odd)).sum())}


def step_bytes(cfg: dict, mask: np.ndarray) -> int:
    """Least bytes one step of `cfg` moves on the scene `mask` (float32
    planes, 4 bytes a cell, or the transport dtype's size)."""
    item = torch.empty((), dtype=getattr(torch, cfg.get("dtype", "float32"))).element_size()
    n = _cells(mask)
    cip, dye = cfg["scheme"] == "cip", cfg["enable_dye"]
    # (planes, cells at which each is read) of the state read
    reads = [(2, "all"), (1, "all")]  # v, p
    # where a phase keeps the old alternate: CIP at walls, MAC off the fluid
    kept = "wall" if cip else "not_fluid"
    reads.append((2, kept))  # v_alt
    reads.append((1, "wall" if cfg["pressure_solver"] == "jacobi" else "not_odd_fluid"))  # p_alt
    written = 6  # v, v_alt, p, p_alt
    if cip:
        reads += [(4, "all"), (4, "wall")]  # vx, vy; their alternates
        written += 8
    if dye:
        reads += [(3, "all"), (3, kept)]  # dye, dye_alt
        written += 6
        if cip:
            reads += [(6, "all"), (6, "wall")]  # dyex, dyey; their alternates
            written += 12
    state = sum(planes * n[at] for planes, at in reads) * item + written * n["all"] * item
    scene = n["all"] + item * (2 + (3 if dye else 0)) * n["inflow"]  # mask; inflow velocity, dye
    return state + scene + 2 * 4  # the int32 step counter, read and written


_FREE = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "slice", "select", "squeeze", "unsqueeze",
    "permute", "t", "transpose", "as_strided", "alias", "detach", "clone", "copy", "_to_copy",
    "contiguous", "lift_fresh", "lift_fresh_copy", "cat", "stack", "index", "index_select",
    "gather", "split", "unbind", "narrow", "empty", "empty_like", "empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_empty", "new_empty_strided",
    "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange", "_local_scalar_dense",
})
_HEAVY = {"div": 3.0, "sqrt": 3.0, "rsqrt": 3.0, "exp": 3.0, "log": 3.0, "tanh": 3.0,
          "sigmoid": 3.0, "pow": 3.0, "remainder": 3.0, "fmod": 3.0, "reciprocal": 3.0,
          "sign": 2.0}
_REDUCE = frozenset({"sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
                     "argmax", "argmin", "norm", "linalg_vector_norm"})


def _first_tensor(xs):
    for x in xs if isinstance(xs, (tuple, list)) else (xs,):
        if isinstance(x, torch.Tensor):
            return x
    return None


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name.endswith("_") and not name.startswith("_"):
            name = name[:-1]  # in place: add_ counts as add
        if name not in _FREE:
            t = _first_tensor(args) if name in _REDUCE else _first_tensor(out)
            if t is not None:
                self.total += float(t.numel()) * _HEAVY.get(name, 1.0)
        return out


def step_elops(cfg: dict, scene: dict) -> float:
    """Weighted element operations of one reference step of `cfg` on
    `scene` (the arrays of :mod:`bench_port.reference.scenes`), counted on
    shape-only tensors: nothing is computed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from bench_port.reference.step import Reference

    fake = FakeTensorMode()
    with fake:
        mask = torch.as_tensor(scene["mask"])
        ref = Reference(cfg, scene, "cpu")
        x_res, y_res = mask.shape

        def plane(c=None):
            return torch.empty((x_res, y_res) if c is None else (c, x_res, y_res))

        s = {"step": torch.zeros((), dtype=torch.int32), "v": plane(2), "v_alt": plane(2),
             "p": plane(), "p_alt": plane()}
        if cfg["scheme"] == "cip":
            s.update({k: plane(2) for k in ("vx", "vy", "vx_alt", "vy_alt")})
        if cfg["enable_dye"]:
            s.update(dye=plane(3), dye_alt=plane(3))
            if cfg["scheme"] == "cip":
                s.update({k: plane(3) for k in ("dyex", "dyey", "dyex_alt", "dyey_alt")})
        counter = _Counter()
        with counter:
            ref.step(s)
    return counter.total


def least_step_s(cfg: dict, scene: dict) -> dict[str, float]:
    """The least seconds a step takes by each count and the larger of the
    two (``least_s``), with the counts themselves."""
    nbytes = step_bytes(cfg, scene["mask"])
    elops = step_elops(cfg, scene)
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, elops / FP32_FLOPS_PER_S
    return {"bytes": nbytes, "elops": elops, "bytes_s": byte_s, "elops_s": op_s,
            "least_s": max(byte_s, op_s)}
