"""The program under test for one run: its simulator, driven call by call by
the traffic's loop.

A traffic file names one loop, ``loops/<loop>.py``, and its parameters,
and may list probes, ``probes/<probe>.py``, each with its count; both are
found by name (:mod:`bench_port.registry`). A :class:`Session` builds the
program's simulator from a configuration and a seed, makes checked calls
(the window's own call, its state before and after kept on the host for
the check), warms up, runs the window, and with tracing runs the traced
window and the probes.
"""

from __future__ import annotations

import contextlib
import gc
import time
import warnings

import torch

from bench_port import registry
from bench_port.seeded import seeded_state
from bench_port.trace import events_from_profiler, reduce_events, table

__all__ = ["sim_config", "sync", "span", "Session"]

_SIM_FIELDS = ("resolution", "re", "scheme", "vor_eps", "enable_dye", "pressure_solver",
               "sor_omega", "n_pressure_iter", "velocity_limit", "dtype")


def sim_config(cfg: dict) -> dict:
    """The simulator settings a configuration file states, with the
    reference CLI's derived ones (``main.py:56-63``): dt = 0.05/res when
    unset, dx = 1/res, vor_eps 0 meaning none."""
    out = {k: cfg[k] for k in _SIM_FIELDS}
    out["dt"] = cfg["dt"] if cfg.get("dt") else 0.05 / cfg["resolution"]
    out["dx"] = 1.0 / cfg["resolution"]
    if not out["vor_eps"]:
        out["vor_eps"] = None
    return out


def sync(sim) -> None:
    """Wait for the device, then read one value to the host."""
    if sim.state.v.device.type == "cuda":
        torch.cuda.synchronize(sim.state.v.device)
    float(sim.state.v.reshape(-1)[0])


@contextlib.contextmanager
def span(name: str, on: bool):
    """A benchmark span in the profiler's trace, when tracing."""
    if on:
        with torch.profiler.record_function(name):
            yield
    else:
        yield


@contextlib.contextmanager
def _no_gc():
    """The cyclic collector held off (collected first), so that its pauses
    fall outside the window."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _host_leaves(state) -> dict:
    return {name: leaf.detach().cpu() for name, leaf in zip(state._fields, state)
            if leaf is not None}


class Session:
    """The program under test for one cell: its simulator, built on
    `device` from configuration `cfg` and the seeded state of `seed`,
    driven by traffic `traffic` through the loop it names (found under
    `root`)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, root=registry.ROOT):
        from fluid2d_tpu_torch.config import SimConfig
        from fluid2d_tpu_torch.models.simulator import FluidSimulator
        from fluid2d_tpu_torch.scenes.compile import get_scene
        from fluid2d_tpu_torch.state import SimState

        self.traffic = traffic
        self.root = root
        self.loop = registry.loop(traffic["loop"], root)
        self.k = self.loop.steps_per_call(traffic)
        sc = sim_config(cfg)
        simcfg = SimConfig.create(kernels="auto", **{k: v for k, v in sc.items() if k != "dx"})
        scene = get_scene(cfg["scene"], cfg["resolution"], torch.device(device))
        leaves = seeded_state(sc, scene.fluid, seed, cfg["initial_speed"])
        self.sim = FluidSimulator(scene, simcfg, state=SimState(**leaves))

    def call(self, traced: bool = False):
        """One call of the loop; its output (a frame) or None."""
        return self.loop.call(self, traced)

    def checked_call(self, keep_before: bool = True) -> dict:
        """One call as the window makes it, with every state leaf after it
        (and, with `keep_before`, before it) and its output on the host, for
        the check."""
        sync(self.sim)
        before = _host_leaves(self.sim.state) if keep_before else None
        out = self.call()
        sync(self.sim)
        return {"before": before, "state": _host_leaves(self.sim.state), "output": out}

    def warm(self, calls: int) -> None:
        for _ in range(calls):
            self.call()
        sync(self.sim)

    # -- the measured window ---------------------------------------------------------
    def window(self, seconds: float, traced: bool = False) -> dict:
        """Calls until `seconds` have passed, then a synchronize: the
        window's length, the calls and steps it completed and each call's
        time."""
        call_s = []
        with _no_gc():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                c0 = time.perf_counter()
                self.call(traced)
                call_s.append(time.perf_counter() - c0)
            with span("sync", traced):
                sync(self.sim)
            t1 = time.perf_counter()
        return {"window_s": t1 - t0, "calls": len(call_s), "steps": len(call_s) * self.k,
                "call_s": call_s}

    def traced(self, seconds: float, out_file=None) -> dict:
        """The traced run: a profiler window of the traffic, then each
        probe the traffic file lists. Returns the record's parts."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.sim.state.v.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with warnings.catch_warnings():  # the profiler's note on clearing events at its stop
            warnings.filterwarnings("ignore", message=".*Profiler clears events")
            with torch.profiler.profile(activities=acts) as prof:
                win = self.window(min(seconds, self.traffic["trace_seconds"]), traced=True)
        events = events_from_profiler(prof)
        red = reduce_events(events)
        if out_file is not None:
            out_file.parent.mkdir(parents=True, exist_ok=True)
            out_file.write_text(table(events) + "idle seconds by host span: "
                                + repr(red["idle_by_span"]) + "\nlongest gaps: "
                                + repr(red["gaps"]) + "\n")
        red.update(steps=win["steps"], calls=win["calls"])
        rec = {"trace": red}
        for name, n in self.traffic.get("probes", {}).items():
            rec[name] = registry.probe(name, self.root)(self, n)
        return rec

    def nonfinite(self) -> int:
        """Non-finite values in the state."""
        return int(sum(int((~torch.isfinite(leaf)).sum()) for leaf in self.sim.state
                       if leaf is not None and leaf.is_floating_point()))

    def close(self) -> None:
        """Free the program's state on the device."""
        self.sim = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
