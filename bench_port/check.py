"""The check that decides ``correct``: what the timed path produced against
the plain reference, number by number, each against its limit.

Two calls of the window's own kind are checked, on the object the window
drives: the first, from the seeded state, before the warm-up; and the
last, made once the window has closed, from the state the window left
(kept on the host before the call). The numbers:

- ``state_gap`` and ``last_state_gap``: after the call (K steps), the
  widest gap between a state leaf of the program and the reference's, as a
  share of the reference leaf's largest magnitude; the largest over every
  leaf (velocity, pressure, their alternates, the CIP gradient planes and
  the dye, as the configuration has them).
- the loop's numbers on the call's output, ``frame_diff_pct`` and
  ``last_frame_diff_pct`` in a frame loop: the share, in %, of the frame's
  8-bit values that differ from the reference's frame.
- ``nonfinite``: non-finite values in the program's state after the
  window.

For the first call the reference makes the seeded state again from the
seed on its own scene; for the last it starts from the program's state
before the call, in float32. It runs after the program's state is freed.
A limit file states each number's limit; a number above it, missing, or
not a number fails the check.
"""

from __future__ import annotations

import math

import torch

from bench_port import registry
from bench_port.reference import scenes as ref_scenes
from bench_port.reference.step import Reference
from bench_port.seeded import seeded_state
from bench_port.session import sim_config

__all__ = ["reference_numbers", "judge"]


def _state_gap(prog: dict, ref: dict, device) -> float:
    gap = 0.0
    for name in (set(prog) | set(ref)) - {"step"}:
        if name not in prog or name not in ref:
            return math.inf
        r = ref[name]
        d = (prog[name].to(device).float() - r).abs().max().item()
        if math.isnan(d):
            return math.nan
        gap = max(gap, d / max(r.abs().max().item(), 1e-30))
    return gap


def reference_numbers(cfg: dict, traffic: dict, seed: int, first: dict, last: dict | None,
                      device, root=registry.ROOT) -> dict:
    """The numbers of the checked calls `first` and `last` (as
    :meth:`bench_port.session.Session.checked_call` returns them; `last`
    may be None)."""
    sc = sim_config(cfg)
    drawn = ref_scenes.draw(cfg["scene"], cfg["resolution"], root / "reference" / "scenes")
    ref = Reference(sc, {**drawn, **ref_scenes.derive(drawn["mask"])}, device)
    loop = registry.loop(traffic["loop"], root)
    k = loop.steps_per_call(traffic)
    out = {}
    for prefix, got in (("", first), ("last_", last)):
        if got is None:
            continue
        if prefix:
            s0 = {n: (t.float() if t.is_floating_point() else t).to(device)
                  for n, t in got["before"].items()}
        else:
            s0 = seeded_state(sc, ref.fluid, seed, cfg["initial_speed"])
        with torch.no_grad():
            s1 = ref.run(s0, k)
        del s0
        nums = {"state_gap": _state_gap(got["state"], s1, device),
                **loop.numbers(ref, s1, traffic, got["output"])}
        out.update({prefix + n: v for n, v in nums.items()})
        del s1
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """True when every limited number is there, is a number and is at most
    its limit."""
    for name, lim in limits.items():
        x = numbers.get(name)
        if x is None or not isinstance(x, (int, float)) or math.isnan(x) or x > lim:
            return False
    return True
