"""The port's roofline accounting (fluid2d_tpu_torch/utils/profiling.py)
against the JAX package's, on the CPU:

* ``step_min_bytes`` equals the JAX package's exactly, for every scheme,
  dye and confinement switch and pressure iteration count, but for the
  pressure chain, which the port counts per call (the iterations of one
  call keep their pair on chip);
* the byte ledger (``ops/launch.py:TRAFFIC_LOG``) of one step: every
  kernel variant a configuration runs logs exactly its registered operand
  mix (``mix_bytes``), the counterpart of tests/test_profiling.py's
  registry guard; ``kernels="eager"`` logs nothing;
* ``needed_bytes``, the bytes a kernel's bound is taken from: each
  alternate and scene constant counted at the cells whose outputs depend
  on it, held against the plain versions by perturbing it on and off them;
* the element-op counter on toy functions (the counterpart of the JAX
  package's Pallas toy kernels) and on one step;
* the probes' plain versions against NumPy, the FMA chains' checks
  against a missing round, and the probes' CPU behaviour
  (the FMA probe declines, the copy probe times its plain version);
* at bf16 transport: the byte ledger of every kernel variant and chain link
  equals ``mix_bytes(..., itemsize=2)``; the bf16 twin, the dtype-rate
  chains (C5a, against NumPy with ``ml_dtypes``' bfloat16, and their check
  against a step more or fewer) and the row-window copies (C5b) in their
  plain versions;
* ``roofline_report`` keys on the CPU, its floors from the needed bytes
  (never above the whole ledger's, equal without sparse reads), and
  ``trace`` writing a file.
"""

import json

import numpy as np
import pytest
import torch

import ml_dtypes

from fluid2d_tpu.config import SimConfig as JaxConfig
from fluid2d_tpu.utils import profiling as jax_profiling
import fluid2d_tpu_torch as ft
from fluid2d_tpu_torch.models.common import pressure_chain
from fluid2d_tpu_torch.ops import cuda_dtype_probes, cuda_phases, cuda_probes, cuda_stencil, launch
from fluid2d_tpu_torch.utils import profiling

torch.set_num_threads(1)

RES = 32  # scene 2 on a (64, 32) grid


@pytest.mark.parametrize("n_pressure_iter", [1, 2, 6])
@pytest.mark.parametrize("vor_eps", [None, 5.0])
@pytest.mark.parametrize("enable_dye", [False, True])
@pytest.mark.parametrize("scheme", ["upwind", "kk", "cip"])
def test_step_min_bytes_matches_jax(scheme, enable_dye, vor_eps, n_pressure_iter):
    """The JAX package's count (the pressure read and written once an
    iteration) less the 6 planes an iteration that shares a call with
    another does not move: SOR pairs its iterations (1 → 1 call, 2 → 1,
    6 → 3)."""
    kw = dict(resolution=64, scheme=scheme, enable_dye=enable_dye, vor_eps=vor_eps,
              n_pressure_iter=n_pressure_iter)
    cfg = ft.SimConfig.create(**kw)
    got = profiling.step_min_bytes(cfg, 128, 64)
    fused = n_pressure_iter - len(pressure_chain(cfg))
    assert fused == {1: 0, 2: 1, 6: 3}[n_pressure_iter]
    jax_count = jax_profiling.step_min_bytes(JaxConfig.create(**kw), 128, 64)
    assert got == jax_count - 6 * fused * 128 * 64 * 4
    assert got > 0


@pytest.mark.parametrize(("solver", "n", "chain"), [
    ("sor", 0, []), ("sor", 1, [1]), ("sor", 2, [2]), ("sor", 3, [2, 1]), ("sor", 4, [2, 2]),
    ("sor", 5, [2, 2, 1]), ("jacobi", 1, [1]), ("jacobi", 4, [4]), ("jacobi", 6, [4, 2]),
    ("jacobi", 9, [4, 4, 1])])
def test_step_min_bytes_counts_the_pressure_per_call(solver, n, chain):
    """One pass of the pressure (read p, p_alt, u, w; write the pair) a call
    of the greedy chain (models/common.py:pressure_chain), which the byte
    ledger of one step shows too, call by call."""
    cfg = ft.SimConfig.create(resolution=RES, pressure_solver=solver, n_pressure_iter=n)
    assert pressure_chain(cfg) == chain
    calls = len(chain)
    cell = 2 * RES * RES * 4
    base = ft.SimConfig.create(resolution=RES, pressure_solver=solver, n_pressure_iter=1)
    assert (profiling.step_min_bytes(cfg, 2 * RES, RES)
            == profiling.step_min_bytes(base, 2 * RES, RES) + 6 * (calls - 1) * cell)
    if n > 0:
        ledger = _step_ledger(cfg)
        pressure = [name for name, _ in ledger if solver in name]
        assert [int(name.split("_n")[1][0]) if "_n" in name else 1
                for name in pressure] == chain


# configuration → the kernel variants one step of it runs
LEDGER_CONFIGS = {
    "cip": ({}, {"cip_velocity_phase", "confinement", "sor_iteration_n2_v_limit",
                 "cip_dye_phase"}),
    "upwind": ({"scheme": "upwind"}, {"mac_velocity_phase_upwind", "confinement",
                                      "sor_iteration_n2_v_limit", "mac_dye_phase_upwind"}),
    "kk": ({"scheme": "kk"}, {"mac_velocity_phase_kk", "confinement",
                              "sor_iteration_n2_v_limit", "mac_dye_phase_kk"}),
    "cip_jacobi2": ({"pressure_solver": "jacobi"},
                    {"cip_velocity_phase", "confinement", "jacobi_iteration_n2_v_limit",
                     "cip_dye_phase"}),
    "kk_jacobi7": ({"scheme": "kk", "pressure_solver": "jacobi", "n_pressure_iter": 7},
                   {"mac_velocity_phase_kk", "confinement", "jacobi_iteration_n4",
                    "jacobi_iteration_n3_v_limit", "mac_dye_phase_kk"}),
    "upwind_jacobi1_bare": ({"scheme": "upwind", "pressure_solver": "jacobi",
                             "n_pressure_iter": 1, "vor_eps": None, "enable_dye": False},
                            {"mac_velocity_phase_upwind", "jacobi_iteration_n1_v_limit"}),
}


def _step_ledger(cfg) -> list[tuple[str, int]]:
    scene = ft.scene_for_dtype(ft.get_scene(2, RES, "cpu"), cfg)
    state = ft.init_state(scene, cfg, "cpu")
    launch.TRAFFIC_LOG = ledger = []
    try:
        ft.make_step_fn(cfg)(state, scene)
    finally:
        launch.TRAFFIC_LOG = None
    return ledger


@pytest.mark.parametrize("config", list(LEDGER_CONFIGS))
def test_byte_ledger_matches_mix_registry(config):
    kw, names = LEDGER_CONFIGS[config]
    cfg = ft.SimConfig.create(resolution=RES, **kw)
    ledger = _step_ledger(cfg)
    assert {name for name, _ in ledger} == names
    for name, nbytes in ledger:
        assert nbytes == profiling.mix_bytes(name, 2 * RES, RES), name
    per_kernel = profiling.step_kernel_bytes(cfg, RES)
    assert set(per_kernel) == names
    assert sum(per_kernel.values()) == sum(n for _, n in ledger)


# configuration → the kernel variants one bf16 step of it runs: the pressure
# chain's first call returns a float32 pair, its last call reads one.
LEDGER_CONFIGS_BF16 = {
    "cip": ({}, {"cip_velocity_phase", "confinement", "sor_iteration_n2_v_limit",
                 "cip_dye_phase"}),
    "kk_sor1": ({"scheme": "kk", "n_pressure_iter": 1},
                {"mac_velocity_phase_kk", "confinement", "sor_iteration_v_limit",
                 "mac_dye_phase_kk"}),
    "upwind_sor3": ({"scheme": "upwind", "n_pressure_iter": 3},
                    {"mac_velocity_phase_upwind", "confinement", "sor_iteration_n2_f32out",
                     "sor_iteration_f32in_v_limit", "mac_dye_phase_upwind"}),
    "kk_sor6": ({"scheme": "kk", "n_pressure_iter": 6},
                {"mac_velocity_phase_kk", "confinement", "sor_iteration_n2_f32out",
                 "sor_iteration_n2_f32in_f32out", "sor_iteration_n2_f32in_v_limit",
                 "mac_dye_phase_kk"}),
    "cip_jacobi6": ({"pressure_solver": "jacobi", "n_pressure_iter": 6},
                    {"cip_velocity_phase", "confinement", "jacobi_iteration_n4_f32out",
                     "jacobi_iteration_n2_f32in_v_limit", "cip_dye_phase"}),
    "kk_jacobi2": ({"scheme": "kk", "pressure_solver": "jacobi"},
                   {"mac_velocity_phase_kk", "confinement", "jacobi_iteration_n2_v_limit",
                    "mac_dye_phase_kk"}),
}


@pytest.mark.parametrize("config", list(LEDGER_CONFIGS_BF16))
def test_byte_ledger_matches_mix_registry_bf16(config):
    kw, names = LEDGER_CONFIGS_BF16[config]
    cfg = ft.SimConfig.create(resolution=RES, dtype="bfloat16", **kw)
    ledger = _step_ledger(cfg)
    assert {name for name, _ in ledger} == names
    for name, nbytes in ledger:
        assert nbytes == profiling.mix_bytes(name, 2 * RES, RES, itemsize=2), name
    assert profiling.step_kernel_bytes(cfg, RES) == {
        name: sum(n for k, n in ledger if k == name) for name in names}


def _variant_calls(dtype):
    """(ledger name, wrapper call) for every kernel variant and pressure
    chain link at the transport `dtype`, on CPU tensors."""
    scene = ft.scene_for_dtype(ft.get_scene(2, RES, "cpu"),
                               ft.SimConfig.create(resolution=RES, dtype=dtype))
    dt = getattr(torch, dtype)
    shape = scene.shape
    gen = torch.Generator().manual_seed(3)

    def rnd(*lead):
        return torch.randn((*lead, *shape), generator=gen).to(dt)

    v, va, p, dye = rnd(2), rnd(2), rnd(), rnd(3)
    grads = [rnd(2) for _ in range(4)]
    dgrads = [rnd(3) for _ in range(4)]
    cfg = ft.SimConfig.create(resolution=RES)
    calls = [
        ("confinement", lambda: cuda_phases.confinement_cuda(v, va, scene.fluid8, cfg.dt, 5.0,
                                                             cfg.dx)),
        ("cip_velocity_phase", lambda: cuda_phases.cip_velocity_phase_cuda(
            v, p, va, *grads, scene, cfg.re, cfg.dt, cfg.dx)),
        ("cip_dye_phase", lambda: cuda_phases.cip_dye_phase_cuda(
            dye, dye, *dgrads, v, scene, cfg.re, cfg.dt, cfg.dx)),
        ("cip_advect", lambda: cuda_stencil.cip_advect_cuda(
            dye, *dgrads[:2], v, dye, *dgrads[2:], scene.fluid8, cfg.dt, cfg.dx)),
        ("cip_advect_self", lambda: cuda_stencil.cip_advect_cuda(
            v, *grads[:2], v, va, *grads[2:], scene.fluid8, cfg.dt, cfg.dx)),
    ]
    for s in ("upwind", "kk"):
        calls.append((f"mac_velocity_phase_{s}", lambda s=s: cuda_phases.mac_velocity_phase_cuda(
            v, p, va, scene, s, cfg.re, cfg.dt, cfg.dx)))
        calls.append((f"mac_dye_phase_{s}", lambda s=s: cuda_phases.mac_dye_phase_cuda(
            dye, dye, v, scene, s, cfg.dt, cfg.dx)))
    wides = (False, True) if dt != torch.float32 else (False,)
    for wide_in in wides:
        for wide_out in wides:
            pi = p.float() if wide_in else p
            out = torch.float32 if wide_out else dt
            link = ("_f32in" if wide_in else "") + ("_f32out" if wide_out else "")
            for lim in (None, 10.0):
                sfx = link + ("" if lim is None else "_v_limit")
                for n in (1, 2):
                    calls.append((("sor_iteration" if n == 1 else "sor_iteration_n2") + sfx,
                                  lambda pi=pi, out=out, lim=lim, n=n: (
                                      cuda_stencil.sor_iteration_cuda(
                                          pi, pi, v[0], v[1], scene.pbc_code, scene.fluid8, 1.3,
                                          cfg.dt, cfg.dx, n_iters=n, v_limit=lim,
                                          out_dtype=out))))
                for n in range(1, 5):
                    calls.append((f"jacobi_iteration_n{n}" + sfx,
                                  lambda pi=pi, out=out, lim=lim, n=n: (
                                      cuda_stencil.jacobi_iteration_cuda(
                                          pi, pi, v[0], v[1], scene.pbc_code, scene.not_wall8,
                                          cfg.dt, cfg.dx, n_iters=n, v_limit=lim,
                                          out_dtype=out))))
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_variant_logs_its_mix_bytes(dtype):
    """Each wrapper call logs one ledger entry: its variant's registered
    mix at the transport dtype's itemsize; the outputs are of the dtypes
    the mix says (the pair float32 on a ``_f32out`` link)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    calls = _variant_calls(dtype)
    names = set()
    for name, call in calls:
        launch.TRAFFIC_LOG = ledger = []
        try:
            outs = call()
        finally:
            launch.TRAFFIC_LOG = None
        assert ledger == [(name, profiling.mix_bytes(name, 2 * RES, RES, itemsize))], name
        wide_out = "_f32out" in name
        for k, o in enumerate(outs):
            want = torch.float32 if wide_out and k < 2 else getattr(torch, dtype)
            assert o.dtype == want, f"{name}[{k}]"
        names.add(name)
    if dtype == "bfloat16":
        assert names == set(profiling._KERNEL_MIXES)


def test_byte_ledger_is_off_by_default_and_empty_for_eager():
    assert launch.TRAFFIC_LOG is None
    cfg = ft.SimConfig.create(resolution=RES, kernels="eager")
    assert _step_ledger(cfg) == []
    assert profiling.step_kernel_bytes(cfg, RES) == {}
    assert profiling.mix_bytes("no_such_kernel", 64, 32) is None
    assert profiling.measure_mix_ceiling("no_such_kernel", 64, 32, device="cpu") is None


def _sparse_calls(scene):
    """{mix: (plain call of named operands, the operands, the operand at
    each of the mix's sparse positions)} on seeded float32 CPU planes; the
    dye alternates and colours lie in [0.25, 0.75], so that a perturbation
    of 0.125 stays inside the dye's [0, 1] clamp."""
    gen = torch.Generator().manual_seed(17)
    shape = scene.shape

    def rnd(*lead, lo=None):
        if lo is not None:
            return lo + 0.5 * torch.rand((*lead, *shape), generator=gen)
        return torch.randn((*lead, *shape), generator=gen)

    cfg = ft.SimConfig.create(resolution=RES)
    ops = {"v": rnd(2), "v_alt": rnd(2), "p": rnd(), "p_alt": rnd(), "u": 8 * rnd(), "w": 8 * rnd(),
           "dye": rnd(3, lo=0.25), "dye_alt": rnd(3, lo=0.25), "bc_const": rnd(2),
           "bc_dye": rnd(3, lo=0.25), **{f"g{k}": 0.1 * rnd(2) for k in range(4)},
           **{f"d{k}": 0.1 * rnd(3) for k in range(4)}}
    consts = (cfg.re, cfg.dt, cfg.dx)

    def sc(o):
        return scene._replace(bc_const=o["bc_const"], bc_dye=o["bc_dye"])

    calls = {
        "confinement": (lambda o: cuda_phases.confinement_plain(
            o["v"], o["v_alt"], scene.fluid8, cfg.dt, 5.0, cfg.dx), {1: "v_alt"}),
        "cip_velocity_phase": (lambda o: cuda_phases.cip_velocity_phase_plain(
            o["v"], o["p"], o["v_alt"], o["g0"], o["g1"], o["g2"], o["g3"], sc(o), *consts),
            {2: "v_alt", 4: "g1", 6: "g3", 7: "bc_const"}),
        "cip_dye_phase": (lambda o: cuda_phases.cip_dye_phase_plain(
            o["dye"], o["dye_alt"], o["d0"], o["d1"], o["d2"], o["d3"], o["v"], sc(o), *consts),
            {1: "dye_alt", 3: "d1", 5: "d3", 7: "bc_dye"}),
        "cip_advect": (lambda o: cuda_stencil.cip_advect_plain(
            o["dye"], o["d0"], o["d1"], o["v"], o["dye_alt"], o["d2"], o["d3"], scene.fluid8,
            cfg.dt, cfg.dx), {4: "dye_alt", 5: "d2", 6: "d3"}),
        "cip_advect_self": (lambda o: cuda_stencil.cip_advect_plain(
            o["v"], o["g0"], o["g1"], o["v"], o["v_alt"], o["g2"], o["g3"], scene.fluid8,
            cfg.dt, cfg.dx), {3: "v_alt", 4: "g2", 5: "g3"}),
    }
    for s in ("upwind", "kk"):
        calls[f"mac_velocity_phase_{s}"] = (lambda o, s=s: cuda_phases.mac_velocity_phase_plain(
            o["v"], o["p"], o["v_alt"], sc(o), s, *consts), {2: "v_alt", 3: "bc_const"})
        calls[f"mac_dye_phase_{s}"] = (lambda o, s=s: cuda_phases.mac_dye_phase_plain(
            o["dye"], o["dye_alt"], o["v"], sc(o), s, cfg.dt, cfg.dx), {1: "dye_alt", 3: "bc_dye"})
    for lim in (None, 10.0):
        sfx = "" if lim is None else "_v_limit"
        for n in (1, 2):
            calls[("sor_iteration" if n == 1 else "sor_iteration_n2") + sfx] = (
                lambda o, n=n, lim=lim: cuda_stencil.sor_iteration_plain(
                    o["p"], o["p_alt"], o["u"], o["w"], scene.pbc_code, scene.fluid8, 1.3,
                    cfg.dt, cfg.dx, n_iters=n, v_limit=lim), {1: "p_alt"})
        for n in range(1, 5):
            calls[f"jacobi_iteration_n{n}{sfx}"] = (
                lambda o, n=n, lim=lim: cuda_stencil.jacobi_iteration_plain(
                    o["p"], o["p_alt"], o["u"], o["w"], scene.pbc_code, scene.not_wall8,
                    cfg.dt, cfg.dx, n_iters=n, v_limit=lim), {1: "p_alt"})
    return calls, ops


def _changed_cells(a, b) -> torch.Tensor:
    """(X, Y): the cells where any output plane differs, NaN equal to NaN."""
    out = None
    for x, y in zip(a, b):
        diff = ~((x == y) | (torch.isnan(x) & torch.isnan(y)))
        diff = diff.reshape(-1, *diff.shape[-2:]).any(0)
        out = diff if out is None else out | diff
    return out


SPARSE_MIXES = sorted(profiling._SPARSE_READS)
SPARSE_BASE = [m for m in SPARSE_MIXES if "_f32" not in m]


def test_every_mix_with_alternates_has_its_sparse_reads():
    """Each sparse position names an existing plane group of its mix; every
    mix that takes an alternate or a scene constant is in the table."""
    for mix, reads in profiling._SPARSE_READS.items():
        desc = profiling._KERNEL_MIXES[mix]
        for (key, pos), rule in reads.items():
            assert 0 <= pos < len(desc[key]) and rule in profiling._CELLS, (mix, key, pos)
    assert set(SPARSE_MIXES) == set(profiling._KERNEL_MIXES)


def re_bc(mix: str) -> bool:
    """A pressure call of two or more iterations: its second BC rewrites
    some cells of the first iteration's result."""
    return "iteration_n" in mix and not mix.startswith("jacobi_iteration_n1")


@pytest.mark.parametrize("bc", [1, 2, 3])
@pytest.mark.parametrize("mix", SPARSE_BASE)
def test_needed_bytes_count_the_cells_the_function_reads(mix, bc):
    """The sparse reads' rule holds against the plain version: an operand
    changed off its cells changes no output bit; changed on its cells, it
    changes an output at every one of them (at two or more pressure
    iterations, every one that no BC rewrites: pbc_code 0). needed_bytes is
    mix_bytes less the unread cells, at either itemsize."""
    scene = ft.get_scene(bc, RES, "cpu")
    calls, ops = _sparse_calls(scene)
    call, names = calls[mix]
    ref = call(ops)
    cells = scene.shape[0] * scene.shape[1]
    unread_bytes = 0
    for (key, pos), rule in profiling._SPARSE_READS[mix].items():
        name = names[pos]
        on = profiling._CELLS[rule](scene)
        assert 0 < int(on.sum()) < cells, (name, rule)
        for where, want_changed in ((~on, False), (on, True)):
            bumped = dict(ops, **{name: torch.where(where, ops[name] + 0.125, ops[name])})
            changed = _changed_cells(call(bumped), ref)
            if not want_changed:
                assert not changed.any(), (name, rule, "off its cells")
            else:
                must = on & (scene.pbc_code == 0) if re_bc(mix) else on
                assert changed[must].all(), (name, rule, int((must & ~changed).sum()))
        unread_bytes += (ops[name].numel() // cells) * (cells - int(on.sum()))
    for itemsize in (4, 2):
        assert profiling.needed_bytes(mix, scene, itemsize) == (
            profiling.mix_bytes(mix, *scene.shape, itemsize) - itemsize * unread_bytes)


def test_needed_bytes_of_a_wide_link_count_the_float32_pair():
    """On an _f32in link p_alt is float32 whatever the transport dtype."""
    scene = ft.get_scene(2, RES, "cpu")
    cells = scene.shape[0] * scene.shape[1]
    unread = cells - int(scene.odd_fluid.logical_not().sum())
    for name in ("sor_iteration_n2_f32in_v_limit", "sor_iteration_f32in_f32out"):
        assert profiling.needed_bytes(name, scene, 2) == (
            profiling.mix_bytes(name, *scene.shape, 2) - 4 * unread)
    assert profiling.needed_bytes("no_such_kernel", scene) is None


def test_elop_counter_counts_a_mul_add_exactly():
    x = torch.ones((32, 128))
    total, per_kernel = profiling.collect_elops(lambda t: t * 2.0 + 1.0, x)
    assert total == 2 * 32 * 128
    assert per_kernel == {}


def test_elop_counter_weighs_divide_above_multiply():
    x = torch.ones((8, 128))
    div, _ = profiling.collect_elops(lambda t: t / 3.0, x)
    mul, _ = profiling.collect_elops(lambda t: t * 3.0, x)
    assert div > mul > 0


def test_step_elops_align_with_the_byte_ledger():
    cfg = ft.SimConfig.create(resolution=RES)
    elops = profiling.step_kernel_elops(cfg, RES)
    assert set(elops) == set(profiling.step_kernel_bytes(cfg, RES))
    assert all(v > 0 for v in elops.values())
    assert elops["cip_dye_phase"] > elops["confinement"]


def test_fma_probe_declines_on_cpu():
    assert profiling.measure_fma_throughput(device="cpu") is None


def test_copy_probe_times_the_plain_version_on_cpu():
    assert profiling.measure_hbm_bandwidth(mbytes=2, iters=10, device="cpu") > 0


def test_copy_plain_matches_numpy():
    a = np.random.default_rng(0).standard_normal(4 * 100 + 3).astype(np.float32)
    got = cuda_probes.copy_add1_cuda(torch.from_numpy(a.copy()))
    np.testing.assert_array_equal(got.numpy(), a + np.float32(1))
    out = torch.empty(a.shape)
    assert cuda_probes.copy_add1_cuda(torch.from_numpy(a.copy()), out=out) is out
    np.testing.assert_array_equal(out.numpy(), a + np.float32(1))


@pytest.mark.parametrize("mix", ["cip_velocity_phase", "mac_dye_phase_kk",
                                 "jacobi_iteration_n4_v_limit"])
def test_mix_twin_plain_matches_numpy(mix):
    """The plain twin is the sum of the inputs in order, f32 then int8,
    on every output plane: the same float32 additions as NumPy's."""
    ops = profiling.twin_operands(mix, 2 * RES, RES, "cpu")
    got = cuda_probes.mix_twin_cuda(ops)
    acc = np.zeros((2 * RES, RES), np.float32)
    for t in ops.f32_in:
        acc = acc + t.numpy()
    for t in ops.i8_in:
        acc = acc + t.numpy().astype(np.float32)
    desc = profiling._KERNEL_MIXES[mix]
    assert len(got) == sum(desc["f_out"]) + sum(desc.get("w_out", ()))
    assert len(ops.f32_in) == sum(desc["f_in"]) + sum(desc.get("w_in", ()))
    assert len(ops.i8_in) == sum(desc["i8_in"]) and not ops.bf16_in
    for g in got:
        np.testing.assert_array_equal(g.numpy(), acc)
    planes = 4 * len(ops.f32_in) + len(ops.i8_in) + 4 * len(got)
    assert profiling.mix_bytes(mix, 2 * RES, RES) == planes * 2 * RES * RES


def test_bf16_mix_twin_plain_matches_numpy():
    """The bf16 twin (C5c): bf16 transport planes, float32 pair planes, the
    sum in float32 in table order, rounded to bf16 in the bf16 outputs."""
    mix = "jacobi_iteration_n2_f32in_v_limit"
    ops = profiling.twin_operands(mix, 2 * RES, RES, "cpu", "bfloat16")
    assert (len(ops.f32_in), len(ops.bf16_in), len(ops.i8_in)) == (2, 2, 2)
    got = cuda_probes.mix_twin_cuda(ops)
    acc = np.zeros((2 * RES, RES), np.float32)
    for t in (*ops.f32_in, *ops.bf16_in, *ops.i8_in):
        acc = acc + t.float().numpy()
    assert [g.dtype for g in got] == [torch.bfloat16] * 4
    for g in got:
        np.testing.assert_array_equal(g.float().numpy(),
                                      acc.astype(ml_dtypes.bfloat16).astype(np.float32))
    # the pair at 4 bytes, u, w and the four outputs at 2, the codes at 1
    assert profiling.mix_bytes(mix, 2 * RES, RES, 2) == (2 * 4 + 6 * 2 + 2) * 2 * RES * RES
    for fn in (cuda_probes.mix_twin_cuda, cuda_probes.mix_twin_bf16_cuda):
        for g, r in zip(fn(ops), got):
            assert torch.equal(g, r)


def test_dtype_rate_check_holds_the_timed_inputs_at_both_depths():
    """check_dtype_rate on given inputs: the check depth with its one-step-off
    control, and the timed depth when asked; refuses inputs of another dtype."""
    from fluid2d_tpu_torch.scripts.vpu_dtype_probe import check_dtype_rate

    x = (2.0 + torch.rand((8, 64), generator=torch.Generator().manual_seed(3))).to(torch.bfloat16)
    res = check_dtype_rate("fma", torch.bfloat16, "cpu", passes=96, x=x)
    assert res["max_err_ulps"] == res["max_err_ulps_deep"] == 0.0
    assert res["one_step_off_min_ulps"] > res["tol_ulps"]
    assert "max_err_ulps_deep" not in check_dtype_rate("poly", torch.bfloat16, "cpu", x=x)
    with pytest.raises(TypeError, match="inputs"):
        check_dtype_rate("fma", torch.float32, "cpu", x=x)


def _np_rate(x: np.ndarray, passes: int, mode: str, dtype) -> np.ndarray:
    """C5a's chains in NumPy: each instruction in float64, rounded to
    `dtype` (ml_dtypes' bfloat16 or float32) through float32."""
    c1, c2, c3 = cuda_dtype_probes.RATE_CONSTS

    def rnd(a):
        return a.astype(np.float32).astype(dtype).astype(np.float64)

    a = x.astype(np.float64)
    for _ in range(passes // cuda_dtype_probes.PASSES_PER_STEP[mode]):
        if mode == "fma":
            a = rnd(a * c1 + c2)
        elif mode == "poly":
            a = rnd(rnd(a * a) * c3 + rnd(a * c1 + c2))
        elif mode == "select":
            a = rnd(a * np.where(a > 0, c1, -c1) + c2)
        else:
            a = rnd(rnd(rnd(a * a) * np.where(a > 0, c3, -c3) + a) * c1 + c2)
    return a.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", cuda_dtype_probes.RATE_MODES)
def test_dtype_rate_plain_matches_numpy_and_sees_a_step(mode, dtype):
    """C5a's plain version equals a NumPy emulation bit for bit, stays
    finite at a timed depth, and one step more or fewer moves every element
    by more than the card's check allows (RATE_TOL_ULPS)."""
    dt = getattr(torch, dtype)
    x = (2.0 + torch.rand((32, 64), generator=torch.Generator().manual_seed(5))).to(dt)
    passes = cuda_dtype_probes.RATE_CHECK_PASSES
    got = cuda_dtype_probes.dtype_rate_cuda(x, passes, mode)
    assert got.dtype == dt
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    np.testing.assert_array_equal(got.float().numpy(), _np_rate(x.float().numpy(), passes, mode,
                                                                npdt))
    step = cuda_dtype_probes.PASSES_PER_STEP[mode]
    tol = cuda_dtype_probes.RATE_TOL_ULPS[dt]
    for off in (-step, step):
        other = cuda_dtype_probes.dtype_rate_plain(x, passes + off, mode)
        assert float(cuda_dtype_probes.ulps_apart(other, got).min()) > tol
    assert float(cuda_dtype_probes.ulps_apart(x, got).max()) > tol  # not the input
    deep = cuda_dtype_probes.dtype_rate_plain(x[:2], 3072, mode)
    assert bool(torch.isfinite(deep.float()).all())
    with pytest.raises(ValueError, match="multiple of"):
        cuda_dtype_probes.dtype_rate_cuda(x, step * 7 + 1 if step > 1 else 0, mode)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", cuda_dtype_probes.COPY_MODES)
def test_row_copy_plain_matches_numpy(mode, dtype):
    """C5b's three window moves as NumPy slices (t = 16)."""
    x = (torch.arange(256 * 256, dtype=torch.float32).reshape(256, 256) * 1e-4).to(
        getattr(torch, dtype))
    got = cuda_dtype_probes.row_copy_cuda(x, mode).numpy()
    a = x.float().numpy()
    want = {"tail": a[8:24], "head": a[8:24],
            "realign": np.concatenate([a[:8], a[:8]])}[mode]
    assert got.dtype == np.float32 and got.shape == (16, 256)
    np.testing.assert_array_equal(got, want)


def test_fma_plain_matches_numpy():
    """Eight chains of a = a·c1 + c2 (two float32 roundings a step), then
    their sum, against NumPy's float32 arithmetic, within 1e-6."""
    x = np.random.default_rng(1).random((16, 64)).astype(np.float32)
    passes, c1, c2 = 64, np.float32(1.000001), np.float32(1e-3)
    got = cuda_probes.fma_rate_cuda(torch.from_numpy(x), passes).numpy()
    accs = [x * np.float32(1.0 + 1e-7 * c) for c in range(cuda_probes.FMA_CHAINS)]
    for _ in range(passes // cuda_probes.FMA_CHAINS):
        accs = [a * c1 + c2 for a in accs]
    ref = accs[0]
    for a in accs[1:]:
        ref = ref + a
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * max(1.0, float(np.abs(ref).max())))
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_probes.fma_rate_cuda(torch.from_numpy(x), 12)


@pytest.mark.parametrize("passes", [64, 8192])
def test_fma_checks_see_one_missing_round(passes):
    """The chains' constants make one round more than the card's checks
    allow: one round short moves every element of the float64 plain
    version beyond fma_rate_error_bound, and the float32 plain version
    beyond 1e-5·max(1, |ref|max); the float32 plain version itself (two
    roundings a step, where the kernel takes one) stays within the bound."""
    x = torch.from_numpy(np.random.default_rng(2).random((8, 64)).astype(np.float32))
    short = passes - cuda_probes.FMA_CHAINS
    bound = cuda_probes.fma_rate_error_bound(x, passes)
    exact = cuda_probes.fma_rate_plain(x.double(), passes)
    assert float((exact - cuda_probes.fma_rate_plain(x.double(), short)).abs().min()) > bound
    got = cuda_probes.fma_rate_plain(x, passes)
    assert float((got.double() - exact).abs().max()) <= bound
    miss = float((got - cuda_probes.fma_rate_plain(x, short)).abs().max())
    assert miss > 1e-5 * max(1.0, float(got.abs().max()))


REPORT_KEYS = {
    "steps_per_sec", "ms_per_step", "streaming_copy_GBps", "min_traffic_MB_per_step",
    "kernel_traffic_MB_per_step", "copy_roofline_ms_per_step", "pct_of_copy_roofline",
    "kernels", "geometry_floor_ms_per_step", "pct_of_geometry_roofline", "hbm_note", "device",
    "ledger_geometry_floor_ms_per_step", "pct_of_ledger_geometry_roofline",
}


def test_roofline_report_keys_on_cpu():
    rep = profiling.roofline_report(res=16, steps=2, device="cpu")
    assert set(rep) == REPORT_KEYS  # no fma_rate_Gelops: the FMA probe declines on the CPU
    assert rep["device"] == "cpu"
    json.dumps(rep)
    assert set(rep["kernels"]) == LEDGER_CONFIGS["cip"][1]
    for name, row in rep["kernels"].items():
        assert {"MB_per_step", "ceiling_GBps", "mem_floor_ms", "floor_ms"} <= set(row), name
        assert row["ceiling_GBps"] > 0 and row["floor_ms"] == row["mem_floor_ms"] > 0
    assert rep["geometry_floor_ms_per_step"] == pytest.approx(
        sum(r["floor_ms"] for r in rep["kernels"].values()))


@pytest.mark.parametrize("sparse", [True, False], ids=["needed", "no_sparse_reads"])
def test_roofline_floors_take_the_needed_bytes(sparse, monkeypatch):
    """Each kernel's floor is its needed bytes over its ceiling: never above
    the floor of its whole ledger, which stands beside it, and equal to it
    when the kernel has no sparse reads (the table emptied)."""
    if not sparse:
        monkeypatch.setattr(profiling, "_SPARSE_READS", {})
    rep = profiling.roofline_report(res=16, steps=2, device="cpu")
    scene = ft.get_scene(2, 16, "cpu")
    for name, row in rep["kernels"].items():
        share = (profiling.needed_bytes(name, scene)
                 / profiling.mix_bytes(name, *scene.shape))
        assert row["needed_MB_per_step"] == pytest.approx(share * row["MB_per_step"]), name
        assert row["floor_ms"] <= row["ledger_floor_ms"], name
        assert row["floor_ms"] == pytest.approx(share * row["ledger_floor_ms"]), name
        assert (share == 1.0) == (not sparse), name
    assert rep["geometry_floor_ms_per_step"] <= rep["ledger_geometry_floor_ms_per_step"]
    assert rep["ledger_geometry_floor_ms_per_step"] == pytest.approx(
        sum(r["ledger_floor_ms"] for r in rep["kernels"].values()))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        (torch.arange(8.0) * 2).sum()
    files = list((tmp_path / "trace").glob("*.json"))
    assert files and files[0].stat().st_size > 0
    assert json.loads(files[0].read_text())["traceEvents"]
    assert prof.key_averages()
