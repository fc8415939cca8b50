"""The graph path of the run loop, on the CPU (``models/replay.py``).

What runs here: the ``out=`` of the step's seven kernel wrappers on their
plain path (the result bit-equal to the call without it, landing in the
given tensors, an aliasing or misshaped output refused, and the byte
ledger's entry the same with it as without, the standalone advection's two
forms included); the slot plans of
CIP, upwind and KK with and without confinement and dye, with SOR and
Jacobi chains of one and of several calls, at float32 and bf16, checked by
a replay of the plan independent of the planner (every phase reads the
value it expects, writes no buffer it reads, and two steps return to L0);
the planned steps, through the wrappers' plain paths into a workspace
filled with NaN, bit-equal to ``make_run_fn``'s loop; the copy of a state
in no layout into L0; and the rule of where the graph path engages. The
capture and the replays need a card: ``tests/test_torch_cuda.py``.
"""

import itertools

import pytest
import torch

from fluid2d_tpu_torch import FluidSimulator, SimConfig, get_scene, init_state, make_run_fn
from fluid2d_tpu_torch import scene_for_dtype
from fluid2d_tpu_torch.models.replay import (
    StepGraphs,
    engages,
    group_of,
    slot_plan,
    step_phases,
)
from fluid2d_tpu_torch.ops import cuda_phases, cuda_stencil, launch
from fluid2d_tpu_torch.utils import trace

RES = 12  # scene 2 on a (24, 12) grid


def _wrapper_calls():
    """(id, wrapper, args, kwargs, outputs written) for each wrapper a step
    calls, on seeded CPU inputs."""
    cfg = SimConfig.create(resolution=RES, re=1000.0)
    sc = get_scene(2, RES, "cpu")
    gen = torch.Generator().manual_seed(18)

    def rnd(lead, scale):
        return scale * torch.randn((*lead, *sc.shape), generator=gen)

    p, pa, u, w = rnd((), 0.3), rnd((), 0.3), rnd((), 2.0), rnd((), 2.0)
    v, va = rnd((2,), 0.5), rnd((2,), 0.5)
    vg = [rnd((2,), 0.1) for _ in range(4)]
    dye = rnd((3,), 0.2) + 0.5
    dg = [rnd((3,), 0.1) for _ in range(5)]
    sor = (p, pa, u, w, sc.pbc_code, sc.fluid8, cfg.sor_omega, cfg.dt, cfg.dx)
    jacobi = (p, pa, u, w, sc.pbc_code, sc.not_wall8, cfg.dt, cfg.dx)
    lim = {"v_limit": cfg.velocity_limit}
    return [
        ("sor", cuda_stencil.sor_iteration_cuda, sor, {"n_iters": 2}, 2),
        ("sor_v_limit", cuda_stencil.sor_iteration_cuda, sor, {"n_iters": 2, **lim}, 3),
        ("sor_f32out", cuda_stencil.sor_iteration_cuda, sor, {"out_dtype": torch.float32}, 2),
        ("jacobi", cuda_stencil.jacobi_iteration_cuda, jacobi, {"n_iters": 4}, 2),
        ("jacobi_v_limit", cuda_stencil.jacobi_iteration_cuda, jacobi, {"n_iters": 2, **lim}, 3),
        ("confinement", cuda_phases.confinement_cuda, (v, va, sc.fluid8, cfg.dt, 5.0, cfg.dx),
         {}, 1),
        ("cip_velocity", cuda_phases.cip_velocity_phase_cuda,
         (v, p, va, *vg, sc, cfg.re, cfg.dt, cfg.dx), {}, 6),
        ("cip_dye", cuda_phases.cip_dye_phase_cuda, (dye, *dg, v, sc, cfg.re, cfg.dt, cfg.dx),
         {}, 6),
        *((f"mac_velocity_{s}", cuda_phases.mac_velocity_phase_cuda,
           (v, p, va, sc, s, cfg.re, cfg.dt, cfg.dx), {}, 2) for s in ("upwind", "kk")),
        *((f"mac_dye_{s}", cuda_phases.mac_dye_phase_cuda, (dye, dg[0], v, sc, s, cfg.dt, cfg.dx),
           {}, 2) for s in ("upwind", "kk")),
    ]


WRAPPER_IDS = [c[0] for c in _wrapper_calls()]


@pytest.mark.parametrize("which", range(len(WRAPPER_IDS)), ids=WRAPPER_IDS)
def test_out_lands_in_the_given_tensors_bit_equal(which):
    """With ``out=`` the plain path's results are copied into the given
    tensors, bit-equal to the call without it, and those tensors returned
    (confinement: the new velocity, then its input passed through)."""
    _, wrapper, args, kwargs, n_out = _wrapper_calls()[which]
    ref = wrapper(*args, **kwargs)
    out = tuple(torch.full_like(r, float("nan")) for r in ref[:n_out])
    got = wrapper(*args, **kwargs, out=out)
    assert len(got) == len(ref)
    assert all(g is o for g, o in zip(got, out))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    if n_out < len(ref):  # confinement's alternate: its input, not a copy
        assert got[1] is args[0]


@pytest.mark.parametrize("which", range(len(WRAPPER_IDS)), ids=WRAPPER_IDS)
def test_out_refuses_aliasing_misshaped_or_miscounted_outputs(which):
    """An output that shares memory with an input raises (the kernels read
    through restrict pointers); so does an output of the wrong shape, or
    the wrong number of outputs."""
    _, wrapper, args, kwargs, n_out = _wrapper_calls()[which]
    ref = wrapper(*args, **kwargs)
    fresh = [torch.empty_like(r) for r in ref[:n_out]]
    alias = args[0] if ref[0].shape == args[0].shape else args[0].expand(ref[0].shape)
    with pytest.raises(ValueError, match="aliases an input"):
        wrapper(*args, **kwargs, out=(alias, *fresh[1:]))
    with pytest.raises(ValueError, match="shape"):
        wrapper(*args, **kwargs, out=(fresh[0][..., :-1], *fresh[1:]))
    with pytest.raises(ValueError, match=f"takes {n_out} tensors"):
        wrapper(*args, **kwargs, out=(*fresh, fresh[0].clone()))


def _ledger_calls():
    """The step's wrapper calls and the standalone advection's two forms,
    (id, wrapper, args, kwargs, outputs written) each."""
    cfg = SimConfig.create(resolution=RES)
    sc = get_scene(2, RES, "cpu")
    gen = torch.Generator().manual_seed(19)

    def fields(chans):
        return [torch.randn((chans, *sc.shape), generator=gen) for _ in range(6)]

    dye, vel = fields(3), fields(2)
    adv = cuda_stencil.cip_advect_cuda
    return [
        *_wrapper_calls(),
        ("cip_advect", adv, (*dye[:3], vel[0], *dye[3:], sc.fluid8, cfg.dt, cfg.dx), {}, 3),
        ("cip_advect_self", adv, (*vel[:3], vel[0], *vel[3:], sc.fluid8, cfg.dt, cfg.dx), {}, 3),
    ]


LEDGER_IDS = [c[0] for c in _ledger_calls()]


@pytest.mark.parametrize("which", range(len(LEDGER_IDS)), ids=LEDGER_IDS)
def test_out_leaves_the_ledger_entry_as_it_is(which):
    """A call with ``out=`` logs the same one ledger entry, name and bytes,
    as the call without it: the outputs are counted from the declared
    specs, whatever tensors are given."""
    _, wrapper, args, kwargs, n_out = _ledger_calls()[which]
    out = tuple(torch.empty_like(r) for r in wrapper(*args, **kwargs)[:n_out])
    entries = []
    for given in ({}, {"out": out}):
        launch.TRAFFIC_LOG = ledger = []
        try:
            wrapper(*args, **kwargs, **given)
        finally:
            launch.TRAFFIC_LOG = None
        entries.append(ledger)
    assert len(entries[0]) == 1
    assert entries[1] == entries[0]


def _plan_config(scheme, conf, dye, chain, dtype) -> SimConfig:
    solver, n = chain
    return SimConfig.create(resolution=RES, re=1000.0, scheme=scheme,
                            vor_eps=5.0 if conf else None, enable_dye=dye,
                            pressure_solver=solver, n_pressure_iter=n, dtype=dtype)


PLAN_AXES = (("cip", "upwind", "kk"), (True, False), (True, False),
             (("sor", 2), ("sor", 3), ("jacobi", 2), ("jacobi", 6)), ("float32", "bfloat16"))
PLAN_CASES = list(itertools.product(*PLAN_AXES))
PLAN_IDS = [f"{s}-{'conf' if c else 'noconf'}-{'dye' if d else 'nodye'}-{ch[0]}{ch[1]}-{dt}"
            for s, c, d, ch, dt in PLAN_CASES]


def _replay_plan(phases, result, plan) -> None:
    """Two steps of `plan` replayed on labelled buffers: every phase finds
    the value it reads where the plan put it, writes no buffer it reads and
    no buffer twice, stays inside its group's buffers; each step leaves
    its fields in distinct buffers at the layout the plan names, the second
    at L0."""
    at = {f: (group_of(f), plan.layouts[0][f]) for f in result}
    held = {slot: ("in", f) for f, slot in at.items()}
    start = {f: ("in", f) for f in result}
    for s in (0, 1):
        where = {}
        for ph in phases:
            reads = []
            for r in ph.reads:
                slot, want = (at[r], start[r]) if r in result else (where[r], (s, r))
                assert held.get(slot) == want, (s, ph.name, r, slot, held.get(slot), want)
                reads.append(slot)
            slots = [(g, plan.writes[s][w]) for w, g in zip(ph.writes, ph.groups)]
            assert len(set(slots)) == len(slots), (s, ph.name)
            assert not set(slots) & set(reads), (s, ph.name, slots, reads)
            for (g, b), w in zip(slots, ph.writes):
                assert 0 <= b < plan.sizes[g]
                held[(g, b)] = (s, w)
                where[w] = (g, b)
        at = {f: where[result[f]] for f in result}
        assert len(set(at.values())) == len(at)
        for f, slot in at.items():
            assert held[slot] == (s, result[f])
            assert slot[1] == plan.layouts[(s + 1) % 2][f]
        start = {f: (s, result[f]) for f in result}


@pytest.mark.parametrize("case", PLAN_CASES, ids=PLAN_IDS)
def test_slot_plan_is_sound_and_has_period_two(case):
    cfg = _plan_config(*case)
    phases, result = step_phases(cfg)
    plan = slot_plan(phases, result)
    _replay_plan(phases, result, plan)
    assert plan.sizes["v"] == 4 and plan.sizes["step"] == 2
    assert ("p32" in plan.sizes) == (len(phases) > 3 + cfg.enable_dye + (cfg.vor_eps is not None))


def test_slot_plan_of_the_mac_step_is_the_one_worked_out_by_hand():
    """Upwind with confinement, dye and SOR ×2, velocity buffers 0–3 and L0
    = (v 0, v_alt 1): step 1 writes the velocity phase into 2, 3,
    confinement into 0, the limited velocity into 3 (L1: v 3, v_alt 2); step
    2 writes 1, 0, then 2, then 0 (back to L0); the pressure and dye pairs go
    0, 1 → 2, 3 → 0, 1."""
    phases, result = step_phases(SimConfig.create(resolution=RES, scheme="upwind"))
    plan = slot_plan(phases, result)
    w0, w1 = plan.writes
    assert [w0[k] for k in ("velocity.0", "velocity.1", "confinement.0", "pressure.0.2")] == \
        [2, 3, 0, 3]
    assert [w1[k] for k in ("velocity.0", "velocity.1", "confinement.0", "pressure.0.2")] == \
        [1, 0, 2, 0]
    assert plan.layouts[1] == {"v": 3, "v_alt": 2, "p": 2, "p_alt": 3, "step": 1, "dye": 2,
                               "dye_alt": 3}


def test_slot_plan_raises_without_room():
    phases, result = step_phases(SimConfig.create(resolution=RES, scheme="kk"))
    with pytest.raises(ValueError, match="no slot plan"):
        slot_plan(phases, result, most=3)


def _state(cfg, sc):
    x_rows, y_cols = sc.shape
    fluid = (sc.mask == 0).float()
    gx = torch.linspace(0, 6.283, x_rows)[:, None]
    gy = torch.linspace(0, 6.283, y_cols)[None, :]
    st = init_state(sc, cfg, "cpu")
    dt = st.v.dtype
    st = st._replace(v=torch.stack([0.5 * torch.sin(3 * gx) * torch.cos(2 * gy) * fluid,
                                    0.4 * torch.cos(2 * gx) * torch.sin(gy) * fluid]).to(dt),
                     p=(0.05 * torch.sin(gx + gy) * fluid).to(dt))
    if st.dye is not None:
        st = st._replace(dye=torch.stack([0.5 + 0.4 * torch.sin(k * gx) * torch.cos(gy) * fluid
                                          for k in (1, 2, 3)]).to(dt))
    return st


def _clone(st):
    return st._replace(**{f: t.clone() for f, t in st._asdict().items() if t is not None})


def _assert_equal(got, ref):
    for name, g, r in zip(got._fields, got, ref):
        assert (g is None) == (r is None), name
        if g is not None:
            assert g.dtype == r.dtype and torch.equal(g, r), name


@pytest.mark.parametrize("case", PLAN_CASES, ids=PLAN_IDS)
def test_planned_steps_bit_equal_to_the_run_loop(case):
    """Three planned steps (L0 → L1 → L0 → L1), each output through its
    wrapper's plain path into its planned buffer of a workspace filled with
    NaN, bit-equal to ``make_run_fn``'s three steps, every leaf; L0's
    buffers are the state's own leaves."""
    cfg = _plan_config(*case)
    sc = scene_for_dtype(get_scene(2, RES, "cpu"), cfg)
    st = _state(cfg, sc)
    ref = make_run_fn(cfg)(_clone(st), sc, 3)
    graphs = StepGraphs(st, sc, cfg, fill=float("nan"))
    assert graphs.locate(st) == 0 and graphs.layouts[0].v is st.v
    k = 0
    for _ in range(3):
        k = graphs.planned_step(k)
    assert k == 1
    _assert_equal(graphs.layouts[1], ref)


def test_copy_in_takes_a_state_in_no_layout_into_l0():
    """A state whose leaves are in no layout is copied into L0's buffers,
    one ``graph_state_copies``; one made of L0's own buffers in other
    places (v and v_alt swapped) is copied right too; leaves that share
    memory are not taken as buffers; a misshaped leaf raises."""
    cfg = SimConfig.create(resolution=RES, scheme="upwind")
    sc = get_scene(2, RES, "cpu")
    graphs = StepGraphs(_state(cfg, sc), sc, cfg)
    k = graphs.planned_step(0)
    fresh = _clone(_state(cfg, sc))
    assert graphs.locate(fresh) is None and graphs.locate(graphs.layouts[k]) == k
    copies = trace.graph_state_copies
    graphs.copy_in(fresh)
    assert trace.graph_state_copies == copies + 1
    _assert_equal(graphs.layouts[0], fresh)
    l0 = graphs.layouts[0]
    swapped = l0._replace(v=l0.v_alt, v_alt=l0.v)
    want = _clone(swapped)
    graphs.copy_in(swapped)
    _assert_equal(graphs.layouts[0], want)
    with pytest.raises(ValueError, match="state leaf p"):
        graphs.copy_in(fresh._replace(p=fresh.p[:-1]))
    shared = StepGraphs(fresh._replace(v_alt=fresh.v), sc, cfg)
    assert shared.layouts[0].v is not fresh.v and shared.locate(fresh) is None


@pytest.mark.parametrize(("device", "config", "want"), [
    ("cuda", {}, True),
    ("cuda", {"kernels": "cuda", "scheme": "kk"}, True),
    ("cuda", {"pressure_solver": "jacobi", "n_pressure_iter": 6}, True),
    ("cpu", {}, False),
    ("cuda", {"kernels": "eager"}, False),
    ("cuda", {"n_pressure_iter": 0}, False),
], ids=["cuda", "cuda_kernels_kk", "cuda_jacobi6", "cpu", "kernels_eager", "no_pressure_solve"])
def test_graph_path_engages_on_a_cuda_state_on_the_kernel_path(device, config, want):
    cfg = SimConfig.create(resolution=RES, **config)
    assert engages(cfg, torch.device(device)) is want


@pytest.mark.parametrize("config", [{}, {"kernels": "eager"}, {"n_pressure_iter": 0}],
                         ids=["auto", "kernels_eager", "no_pressure_solve"])
def test_cpu_simulator_runs_the_eager_loop(config):
    """On the CPU ``FluidSimulator.step`` runs the eager loop: no graphs, no
    workspace, no counter of the graph path moves; the values the loop's."""
    sim = FluidSimulator.create(2, RES, device="cpu", **config)
    st = _clone(sim.state)
    counts = (trace.eager_cuda_steps, trace.graph_captures, trace.graph_state_copies,
              sum(trace.graph_replays.values()))
    sim.step(3)
    assert sim._graphs is None
    assert counts == (trace.eager_cuda_steps, trace.graph_captures, trace.graph_state_copies,
                      sum(trace.graph_replays.values()))
    _assert_equal(sim.state, make_run_fn(sim.cfg)(st, sim.scene, 3))
