"""The run loop's graph path: the step captured as CUDA graphs and replayed.

On a CUDA state on the kernel path (:func:`engages`),
``FluidSimulator.step`` does not call the kernel wrappers from Python once
a step: it replays a CUDA graph of the step, which holds the step's
hand-written kernels and the step counter's add with their arguments fixed.
A replay costs the host one graph launch, where the wrappers cost their
checks, allocations and a ctypes call a kernel.

A graph reads and writes fixed addresses, so the step's tensors are fixed
too: a workspace of a few buffers a field, allocated once. The slot plan
(:func:`slot_plan`) puts every output of every phase into a buffer that no
input of that phase uses (the kernels read their inputs through restrict
pointers) and that holds no value still to be read; after two steps every
field is back in its first buffer. So the state has two layouts, L0 and L1,
and there are three graphs: one step L0 → L1, one step L1 → L0, and two
steps L0 → L0 (the pair, one graph launch where two remain, which saves a
graph's launch gap a step). ``step(n)`` replays them from the layout the
state is in: from L1 one step, then pairs, then one step if one remains;
so no step of the call runs outside a graph, an odd n ends in L1, and the
next call starts there. The state's own leaves are L0's
buffers, so entering the graph path copies nothing; a state whose leaves
are in no layout (after ``reset``, or one the caller assigned) is copied
into L0's buffers once.

The graphs are captured at the first call, after one step run through the
wrappers on a side stream (the warm-up, which advances the state: a capture
enqueues nothing). Every kernel is the one the wrappers launch, with the
same arguments, so a replayed step is bit-identical to the eager loop's.

Donation: the buffers are the state's, and a step writes them in place. A
reference to ``sim.state`` (or a leaf of it) held across ``step`` sees the
new values once the buffers are reused, as the JAX package's run, which
donates its state, invalidates it; copy what must be kept.

Counters (``utils/trace.py``): a replay adds its graph's kernel launches to
``launches`` (a capture adds none) and one to ``graph_replays[<key>]``
(``<scheme>.01`` for L0 → L1, ``<scheme>.10`` for L1 → L0,
``<scheme>.pair`` for the pair); a capture adds one to ``graph_captures``
(three a simulator), a copy into L0 one to ``graph_state_copies``, the
warm-up step one to ``eager_cuda_steps``. Each replay runs inside the span
``f2d.graph_replay``.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from fluid2d_tpu_torch.config import SimConfig
from fluid2d_tpu_torch.models.cip import cip_step
from fluid2d_tpu_torch.models.common import pressure_chain
from fluid2d_tpu_torch.models.mac import mac_step
from fluid2d_tpu_torch.ops.launch import overlaps
from fluid2d_tpu_torch.scenes.compile import Scene
from fluid2d_tpu_torch.state import SimState
from fluid2d_tpu_torch.utils import trace
from fluid2d_tpu_torch.utils.trace import span

__all__ = ["Phase", "Plan", "engages", "graph_key", "step_phases", "slot_plan", "StepGraphs"]


def engages(cfg: SimConfig, device: torch.device) -> bool:
    """Whether ``FluidSimulator.step`` replays graphs for a state on
    `device`: a CUDA state, the kernel path (not ``kernels="eager"``), and a
    pressure solve, so that every phase of the step takes ``out=``. Else the
    eager loop runs."""
    return device.type == "cuda" and cfg.kernels != "eager" and bool(pressure_chain(cfg))


def graph_key(cfg: SimConfig, scene: Scene) -> tuple:
    """What a step's graphs are captured for besides their workspace: the
    config and the addresses of the scene's tensors."""
    return cfg, tuple(t.data_ptr() for t in scene)


class Phase(NamedTuple):
    """One kernel call of a step (or the step counter's add), as the slot
    plan sees it: the values it reads, a state field's name or an earlier
    phase's output ``<phase>.<k>``, and the buffer group of each output."""

    name: str  # the key of its outputs in the step's ``out``
    reads: tuple[str, ...]
    groups: tuple[str, ...]

    @property
    def writes(self) -> tuple[str, ...]:
        return tuple(f"{self.name}.{k}" for k in range(len(self.groups)))


def group_of(field: str) -> str:
    """The buffer group of a state field: a field and its alternate share one."""
    return field.removesuffix("_alt")


def step_phases(cfg: SimConfig) -> tuple[list[Phase], dict[str, str]]:
    """The phases of one step of `cfg` in order, as ``models/cip.py`` and
    ``models/mac.py`` run them, and the value each state field holds after
    the step. Groups: one a field (``v``, ``p``, ``vx``, ``vy``, ``dye``,
    ``dyex``, ``dyey``, ``step``), and ``p32`` for the float32 pairs between
    the calls of a pressure chain."""
    phases: list[Phase] = []

    def phase(name: str, reads, groups) -> tuple[str, ...]:
        phases.append(Phase(name, tuple(reads), tuple(groups)))
        return phases[-1].writes

    cip = cfg.scheme == "cip"
    result: dict[str, str] = {}
    if cip:
        v, vx, vy, v_alt, vx_alt, vy_alt = phase(
            "velocity", ("v", "p", "v_alt", "vx", "vx_alt", "vy", "vy_alt"), ("v", "vx", "vy") * 2)
        result.update(vx=vx, vx_alt=vx_alt, vy=vy, vy_alt=vy_alt)
    else:
        v, v_alt = phase("velocity", ("v", "p", "v_alt"), ("v", "v"))
    if cfg.vor_eps is not None:
        (v_new,) = phase("confinement", (v, v_alt), ("v",))
        v, v_alt = v_new, v
    *head, _ = pressure_chain(cfg)
    pair = ("p", "p_alt")
    for k in range(len(head)):
        pair = phase(f"pressure.{k}", (*pair, v), ("p32", "p32"))
    p, p_alt, v = phase(f"pressure.{len(head)}", (*pair, v), ("p", "p", "v"))
    (step,) = phase("step", ("step",), ("step",))
    result.update(step=step, v=v, v_alt=v_alt, p=p, p_alt=p_alt)
    if cfg.enable_dye:
        if cip:
            names = ("dye", "dyex", "dyey", "dye_alt", "dyex_alt", "dyey_alt")
            reads = ("dye", "dye_alt", "dyex", "dyex_alt", "dyey", "dyey_alt", v)
            result.update(zip(names, phase("dye", reads, ("dye", "dyex", "dyey") * 2)))
        else:
            d, d_alt = phase("dye", ("dye", "dye_alt", v), ("dye", "dye"))
            result.update(dye=d, dye_alt=d_alt)
    return phases, result


class Plan(NamedTuple):
    """A slot plan: the buffers of each group; each state field's buffer in
    L0 and in L1; each output's buffer in the step from L0 and in the step
    from L1. In L0 a field is buffer 0 of its group, its alternate 1."""

    sizes: dict[str, int]
    layouts: tuple[dict[str, int], dict[str, int]]
    writes: tuple[dict[str, int], dict[str, int]]


def slot_plan(phases: list[Phase], result: dict[str, str], most: int = 6) -> Plan:
    """The slot plan of a step with period two, each group with the fewest
    buffers that allow one, and of those the first in buffer order.

    Over the two steps L0 → L1 → L0 an output may go into a buffer that
    none of its phase's inputs or earlier outputs uses and whose value is
    dead: read by no later phase, and not a field of the state that its
    step leaves. A depth-first search in each group; a group has at most a
    dozen outputs over two steps."""
    n_phases = len(phases)
    seq = [(s, ph) for s in (0, 1) for ph in phases]

    def value(s: int, name: str):
        if name in result:  # a state field: what the step before left in it
            return ("in", name) if s == 0 else (0, result[name])
        return (s, name)

    last_read: dict = {}
    for t, (s, ph) in enumerate(seq):
        for r in ph.reads:
            last_read[value(s, r)] = t
    kept = {(s, result[f]): (s + 1) * n_phases for s in (0, 1) for f in result}

    def live(x, t: int) -> bool:
        return last_read.get(x, -1) >= t or kept.get(x, 0) > t

    sizes: dict[str, int] = {}
    layouts: tuple[dict, dict] = ({}, {})
    writes: tuple[dict, dict] = ({}, {})
    for g in dict.fromkeys(g for ph in phases for g in ph.groups):
        fields = [f for f in result if group_of(f) == g]
        outs = [(t, s, w) for t, (s, ph) in enumerate(seq)
                for w, gw in zip(ph.writes, ph.groups) if gw == g]

        def search(k: int, bufs: list, chosen: list[int], n: int):
            if k == len(outs):
                done = all(bufs[int(f != g)] == (1, result[f]) for f in fields)
                return chosen if done else None
            t, s, w = outs[k]
            taken = {b for (tj, _, _), b in zip(outs, chosen) if tj == t}
            for b in range(n):
                if b in taken or (bufs[b] is not None and live(bufs[b], t)):
                    continue
                got = search(k + 1, [*bufs[:b], (s, w), *bufs[b + 1:]], [*chosen, b], n)
                if got is not None:
                    return got
            return None

        for n in range(max(2, len(fields)), most + 1):
            start = [None] * n
            for f in fields:
                start[int(f != g)] = ("in", f)
            chosen = search(0, start, [], n)
            if chosen is not None:
                break
        else:
            msg = f"no slot plan of period two with at most {most} buffers for group {g!r}"
            raise ValueError(msg)
        sizes[g] = n
        for (_, s, w), b in zip(outs, chosen):
            writes[s][w] = b
        for f in fields:
            layouts[0][f] = int(f != g)
            layouts[1][f] = writes[0][result[f]]
    return Plan(sizes, layouts, writes)


class StepGraphs:
    """The graph path for one simulator's config and scene: the workspace,
    the two layouts, and the three graphs, captured at the first
    :meth:`run`. `state` gives the shapes and dtypes, and its leaves become
    L0's buffers where they are contiguous and separate. The other buffers
    are uninitialized, or filled with `fill` (a test's NaN, which shows any
    cell a kernel leaves unwritten)."""

    def __init__(self, state: SimState, scene: Scene, cfg: SimConfig,
                 fill: float | None = None):
        self.cfg, self.scene = cfg, scene
        self.key = graph_key(cfg, scene)
        phases, result = step_phases(cfg)
        self.plan = slot_plan(phases, result)
        self.fields = tuple(result)
        leaves = [getattr(state, f) for f in self.fields]
        own = all(t.is_contiguous() for t in leaves) and not any(
            overlaps(a, b) for a, b in itertools.combinations(leaves, 2))
        self.buffers: dict[str, list[torch.Tensor]] = {}
        for g, n in self.plan.sizes.items():
            proto = state.p if g == "p32" else getattr(state, g)
            dtype = torch.float32 if g == "p32" else proto.dtype
            bufs = [] if not own or g == "p32" else [
                t for t in (getattr(state, g), getattr(state, g + "_alt", None)) if t is not None]
            while len(bufs) < n:
                buf = torch.empty(proto.shape, dtype=dtype, device=proto.device)
                if fill is not None and dtype.is_floating_point:
                    buf.fill_(fill)
                bufs.append(buf)
            self.buffers[g] = bufs
        self.layouts = tuple(
            state._replace(**{f: self.buffers[group_of(f)][lay[f]] for f in self.fields})
            for lay in self.plan.layouts)
        self.outs = tuple(
            {ph.name: tuple(self.buffers[g][plan_w[w]] for w, g in zip(ph.writes, ph.groups))
             for ph in phases}
            for plan_w in self.plan.writes)
        self._step = cip_step if cfg.scheme == "cip" else mac_step
        self._graphs: dict | None = None

    def planned_step(self, k: int) -> int:
        """One step from layout k into layout 1 − k through the wrappers,
        each output into its planned buffer (what a graph captures).
        Returns 1 − k."""
        got = self._step(self.layouts[k], self.scene, self.cfg, out=self.outs[k])
        want = self.layouts[1 - k]
        if any(getattr(got, f) is not getattr(want, f) for f in self.fields):
            msg = "the step left its slot plan: step_phases no longer describes it"
            raise RuntimeError(msg)
        return 1 - k

    def locate(self, state: SimState) -> int | None:
        """The layout whose buffers are `state`'s leaves, or None."""
        for k, lay in enumerate(self.layouts):
            if all(getattr(state, f) is getattr(lay, f) for f in self.fields):
                return k
        return None

    def copy_in(self, state: SimState) -> None:
        """Copy `state` into L0's buffers (one ``graph_state_copies``). A leaf
        that shares memory with the workspace is copied out first."""
        work = [b for bufs in self.buffers.values() for b in bufs]
        pairs = []
        for f in self.fields:
            src, dst = getattr(state, f), getattr(self.layouts[0], f)
            if src is None or src.shape != dst.shape or src.dtype != dst.dtype:
                msg = (f"state leaf {f}: {None if src is None else (tuple(src.shape), src.dtype)}; "
                       f"the config's state has {(tuple(dst.shape), dst.dtype)}")
                raise ValueError(msg)
            pairs.append((dst, src.clone() if any(overlaps(src, b) for b in work) else src))
        for dst, src in pairs:
            dst.copy_(src)
        trace.graph_state_copies += 1

    def _capture(self, k: int) -> int:
        """The warm-up step from layout k on a side stream, then the three
        graphs. Returns the layout the warm-up reached."""
        device = self.layouts[0].v.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            k = self.planned_step(k)
        torch.cuda.current_stream(device).wait_stream(side)
        trace.eager_cuda_steps += 1
        # torch.cuda.graph would also collect garbage and empty the cache
        # before each capture: a capture here allocates nothing, so one
        # synchronize and capture_begin/end on the side stream do.
        torch.cuda.synchronize(device)
        graphs = {}
        for name, starts in (("01", (0,)), ("10", (1,)), ("pair", (0, 1))):
            before = dict(trace.launches)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    for j in starts:
                        self.planned_step(j)
                finally:
                    graph.capture_end()
            counts = {e: n - before.get(e, 0) for e, n in trace.launches.items()
                      if n != before.get(e, 0)}
            trace.add_launches(counts, times=-1)  # the capture enqueued nothing
            graphs[name] = (graph, counts, f"{self.cfg.scheme}.{name}")
            trace.graph_captures += 1
        self._graphs = graphs
        return k

    def run(self, state: SimState, n: int) -> SimState:
        """`n` steps from `state`: the state in the layout reached, its
        leaves the workspace's buffers."""
        if n <= 0:
            return state
        k = self.locate(state)
        if k is None:
            self.copy_in(state)
            k = 0
        if self._graphs is None:
            k = self._capture(k)
            n -= 1
        graphs = self._graphs
        done = dict.fromkeys(graphs, 0)
        while n > 0:
            name = "pair" if k == 0 and n >= 2 else ("01", "10")[k]
            with span("f2d.graph_replay"):
                graphs[name][0].replay()
            done[name] += 1
            if name == "pair":
                n -= 2
            else:
                n, k = n - 1, 1 - k
        for name, times in done.items():
            if times:
                graph, counts, key = graphs[name]
                trace.add_launches(counts, times)
                trace.graph_replays[key] += times
        return self.layouts[k]
