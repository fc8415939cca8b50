"""The benchmark's cip1600_jacobi6 settings on the CPU: the headline CIP run
(scene 2, Re 1e6, dt 0.05/res, dye, confinement 5, limit 10) with the
Jacobi pressure solver at six iterations a step.

* 100 steps of the port's path against the JAX package's ``xla`` path,
  every state leaf within 2e-5·max(1, |ref|max), the ROADMAP's multi-step
  tolerance;
* 100 steps of the port's eager path bit-equal to the benchmark's plain
  reference (``bench_port/reference/step.py``) from the benchmark's seeded
  state (this test imports no JAX);
* the pressure chain of six iterations, calls of four and two, and the
  graph path's slot plan holding the head call's float32 pair;
* the launch counter, with the kernel library stood in for by a stub that
  only returns: each Jacobi call counted under its form
  ``f2d_jacobi_iteration.n<N>``, the totals by C entry point as before.
"""

import collections

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch import FluidSimulator, SimConfig, get_scene, init_state
from fluid2d_tpu_torch.models.common import pressure_chain
from fluid2d_tpu_torch.models.replay import StepGraphs, step_phases
from fluid2d_tpu_torch.utils import trace
from fluid2d_tpu_torch.utils.trace import launches
from test_torch_trace import stub_launches  # noqa: F401  (the stub library's fixture)

torch.set_num_threads(1)

STEP_TOL = 2e-5
STEPS = 100
SEED = 2**31 + 1161279231  # more than 32 signed bits hold
# cip1600_jacobi6's settings besides the grid (bench_port/configs/cip1600_jacobi6.json)
JACOBI6 = {"scheme": "cip", "re": 1e6, "vor_eps": 5.0, "enable_dye": True,
           "pressure_solver": "jacobi", "n_pressure_iter": 6, "velocity_limit": 10.0}


def _assert_close(got: dict, ref: dict, tol: float) -> None:
    assert set(got) == set(ref)
    for name in sorted(ref):
        g, r = np.asarray(got[name]), np.asarray(ref[name])
        assert g.shape == r.shape and g.dtype == r.dtype, name
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=tol * scale, rtol=0, err_msg=name)


def _smooth_state(mask: np.ndarray) -> dict[str, np.ndarray]:
    """A smooth moving state on the fluid cells (v, p, dye), as NumPy."""
    x_rows, y_cols = mask.shape
    fluid = (mask == 0).astype(np.float32)
    gx = np.linspace(0, 2 * np.pi, x_rows, dtype=np.float32)[:, None]
    gy = np.linspace(0, 2 * np.pi, y_cols, dtype=np.float32)[None, :]
    return {"v": np.stack([0.5 * np.sin(3 * gx) * np.cos(2 * gy) * fluid,
                           0.4 * np.cos(2 * gx) * np.sin(gy) * fluid]),
            "p": 0.05 * np.sin(gx + gy) * fluid,
            "dye": np.stack([0.5 + 0.4 * np.sin(k * gx) * np.cos(gy) * fluid
                             for k in (1, 2, 3)])}


@pytest.mark.parametrize("res", [20, 32])
def test_jacobi6_settings_hold_100_steps_to_jax(res):
    """100 steps of the port's path (the wrappers' plain versions on the
    CPU) against the JAX package's ``xla`` path from one smooth state."""
    from fluid2d_tpu.config import SimConfig as JaxConfig
    from fluid2d_tpu.models.simulator import make_run_fn as jax_make_run_fn
    from fluid2d_tpu.scenes.compile import get_scene as jax_get_scene
    from fluid2d_tpu.state import init_state as jax_init_state
    import jax.numpy as jnp

    import fluid2d_tpu_torch as ft
    from fluid2d_tpu_torch.convert import scene_from_numpy, state_from_numpy, state_to_numpy

    jax_scene = jax_get_scene(2, res)
    t_scene = scene_from_numpy({k: np.asarray(v) for k, v in zip(jax_scene._fields, jax_scene)},
                               "cpu")
    jcfg = JaxConfig.create(resolution=res, kernels="xla", **JACOBI6)
    smooth = _smooth_state(np.asarray(jax_scene.mask))
    start = jax_init_state(jax_scene, jcfg)._replace(**{k: jnp.asarray(a)
                                                        for k, a in smooth.items()})
    start_np = {k: np.asarray(v) for k, v in zip(start._fields, start) if v is not None}
    ref = jax_make_run_fn(jcfg)(start, jax_scene, STEPS)
    ref = {k: np.asarray(v) for k, v in zip(ref._fields, ref) if v is not None}
    assert int(ref["step"]) == STEPS and np.isfinite(ref["v"]).all()
    assert np.abs(ref["v"]).max() > 1e-2
    cfg = ft.SimConfig.create(resolution=res, **JACOBI6)
    got = state_to_numpy(ft.make_run_fn(cfg)(state_from_numpy(start_np, "cpu"), t_scene, STEPS))
    assert len(ref) == 15  # step, v, p, the CIP gradients, the dye and theirs, alternates
    _assert_close(got, ref, STEP_TOL)


@pytest.mark.parametrize("res", [20, 32])
def test_jacobi6_eager_path_bit_equal_to_the_plain_reference(res):
    """cip1600_jacobi6's settings at a CPU size: 100 steps of the program's
    eager path from the benchmark's seeded state bit-equal to the plain
    reference's, every leaf finite."""
    from bench_port import registry
    from bench_port.reference import scenes
    from bench_port.reference.step import Reference
    from bench_port.seeded import seeded_state
    from bench_port.session import sim_config
    from fluid2d_tpu_torch.state import SimState

    cfg = {**registry.config("cip1600_jacobi6"), "resolution": res}
    sc = sim_config(cfg)
    drawn = scenes.draw(2, res)
    ref = Reference(sc, {**drawn, **scenes.derive(drawn["mask"])}, "cpu")
    s0 = seeded_state(sc, ref.fluid, SEED, cfg["initial_speed"])
    prog_cfg = SimConfig.create(kernels="eager", **{k: v for k, v in sc.items() if k != "dx"})
    assert (prog_cfg.pressure_solver, prog_cfg.n_pressure_iter) == ("jacobi", 6)
    sim = FluidSimulator(get_scene(2, res, "cpu"), prog_cfg,
                         state=SimState(**{k: v.clone() for k, v in s0.items()}))
    sim.step(STEPS)
    s100 = ref.run(s0, STEPS)
    assert int(s100["step"]) == STEPS
    for name, leaf in zip(sim.state._fields, sim.state):
        if leaf is not None:
            assert bool(torch.isfinite(leaf).all()), name
            assert torch.equal(leaf, s100[name]), name
    assert set(s100) == {n for n, leaf in zip(sim.state._fields, sim.state) if leaf is not None}


@pytest.mark.parametrize(("iters", "chain"), [(1, [1]), (4, [4]), (5, [4, 1]), (6, [4, 2]),
                                              (8, [4, 4]), (9, [4, 4, 1])])
def test_jacobi_pressure_chain(iters, chain):
    cfg = SimConfig.create(resolution=12, pressure_solver="jacobi", n_pressure_iter=iters)
    assert pressure_chain(cfg) == chain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jacobi6_slot_plan_holds_the_head_calls_float32_pair(dtype):
    """The step's phases hold two pressure calls; the head call writes its
    pair into two float32 buffers of its own group (``p32``), which the
    last call reads; the last call writes the state's pair and velocity."""
    cfg = SimConfig.create(resolution=12, dtype=dtype, **JACOBI6)
    phases, _ = step_phases(cfg)
    by_name = {ph.name: ph for ph in phases}
    assert [ph.name for ph in phases] == ["velocity", "confinement", "pressure.0", "pressure.1",
                                          "step", "dye"]
    assert by_name["pressure.0"].groups == ("p32", "p32")
    assert by_name["pressure.0"].reads[:2] == ("p", "p_alt")
    assert by_name["pressure.1"].reads[:2] == by_name["pressure.0"].writes
    assert by_name["pressure.1"].groups == ("p", "p", "v")
    sc = get_scene(2, 12, "cpu")
    graphs = StepGraphs(init_state(sc, cfg, "cpu"), sc, cfg)
    assert graphs.plan.sizes["p32"] == 2
    p32 = graphs.buffers["p32"]
    assert all(b.dtype == torch.float32 and b.shape == sc.shape for b in p32)
    for outs in graphs.outs:
        head = outs["pressure.0"]
        assert len(head) == 2 and {id(b) for b in head} == {id(b) for b in p32}
        assert all(b.dtype == getattr(torch, dtype) for b in outs["pressure.1"])


CIP_ENTRIES = {"f2d_cip_velocity_phase": 1, "f2d_confinement": 1, "f2d_cip_dye_phase": 1}


@pytest.mark.parametrize(("iters", "forms"), [
    (2, {"f2d_jacobi_iteration.n2": 1}),
    (6, {"f2d_jacobi_iteration.n4": 1, "f2d_jacobi_iteration.n2": 1}),
    (9, {"f2d_jacobi_iteration.n4": 2, "f2d_jacobi_iteration.n1": 1}),
])
def test_launch_counts_jacobi_forms_apart_with_the_same_totals(stub_launches, iters, forms):
    """Three steps: each Jacobi call under its form, the other kernels under
    their entry points, and the totals by C entry point one launch a call,
    as before the split; the stub is called by the C names, with no form;
    each Jacobi call inside its ``f2d.phase.jacobi`` span."""
    sim = FluidSimulator.create(2, 12, device="cpu", **{**JACOBI6, "n_pressure_iter": iters})
    before, runs_before = dict(launches), trace.entry_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.enabled(True):
            sim.step(3)
    moved = {k: n - before.get(k, 0) for k, n in launches.items() if n != before.get(k, 0)}
    assert moved == {k: 3 * n for k, n in {**CIP_ENTRIES, **forms}.items()}
    calls = sum(forms.values())
    by_entry = {k: n - runs_before[k] for k, n in trace.entry_launches().items()
                if n != runs_before[k]}
    assert by_entry == {k: 3 * n for k, n in {**CIP_ENTRIES,
                                               "f2d_jacobi_iteration": calls}.items()}
    assert collections.Counter(stub_launches.called) == by_entry
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("f2d."))
    inside = [[n for s, e, n in spans if s0 <= s and e <= e0 and n != "f2d.phase.jacobi"]
              for s0, e0, n0 in spans if n0 == "f2d.phase.jacobi"]
    assert inside == [["f2d.launch"]] * (3 * calls)
