"""The last probes' plain versions and harnesses on the CPU: the FMA-rate
sweep (C5d), the geometry twin (C5e, C5f), the row window (C5g) and the el-op
counter's toy kernels (C6), each against NumPy at a small size; the byte and
el-op accounting of their scripts; and each script's entry point, which
refuses to run without a card unless asked for the CPU.

Tolerances: the FMA chains in float64 within ``fma_rate_error_bound`` (the
kernel's own bound; the float32 plain version rounds twice a step); the
geometry twin, the row window and the toys bit-equal to NumPy (the same
float32 operations in the same order, or exact copies).
"""

import io
import contextlib

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch.ops import cuda_probes
from fluid2d_tpu_torch.scripts import (
    dma_geometry_bench,
    dma_geometry_sweep,
    dma_rowwin_1600_check,
    vpu_rate_sweep,
)
from fluid2d_tpu_torch.utils import profiling

torch.set_num_threads(1)

C1, C2 = np.float32(1.000001), np.float32(1e-3)


# --- C5d: the FMA-rate sweep ----------------------------------------------------------


def _np_chains(x: np.ndarray, passes: int, nchain: int) -> np.ndarray:
    """The sweep's chains in float64: start multiplies, passes // nchain
    rounds of a·c1 + c2 per chain, the chains summed in order."""
    accs = [x.astype(np.float64) * float(np.float32(1.0 + 1e-7 * c)) for c in range(nchain)]
    for _ in range(passes // nchain):
        accs = [a * float(C1) + float(C2) for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


@pytest.mark.parametrize("depth", vpu_rate_sweep.DEPTHS)
@pytest.mark.parametrize("nchain", cuda_probes.FMA_SWEEP_CHAINS)
def test_fma_sweep_plain_within_bound_and_sees_a_round(nchain, depth):
    """The float32 plain version of nchain chains within the kernel's
    rounding bound of the float64 NumPy chains, which one round short
    exceeds at every element; the wrapper takes the plain version on the CPU."""
    x = np.random.default_rng(nchain).random((4, 64)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = cuda_probes.fma_sweep_cuda(xt, depth, nchain, threads=1024).double().numpy()
    exact = _np_chains(x, depth, nchain)
    bound = cuda_probes.fma_rate_error_bound(xt, depth, nchain)
    np.testing.assert_allclose(cuda_probes.fma_rate_plain(xt.double(), depth, nchain).numpy(),
                               exact, rtol=1e-15, atol=0)
    assert float(np.abs(got - exact).max()) <= bound
    assert float(np.abs(exact - _np_chains(x, depth - nchain, nchain)).min()) > bound


def test_fma_sweep_refuses_what_the_kernel_does_not_build():
    x = torch.ones((4, 64))
    with pytest.raises(ValueError, match="nchain"):
        cuda_probes.fma_sweep_cuda(x, 64, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_probes.fma_sweep_cuda(x, 60, 8)
    with pytest.raises(ValueError, match="threads"):
        cuda_probes.fma_sweep_cuda(x, 64, 8, threads=2048)
    # C4 keeps its eight chains: the sweep's 8-chain case is its kernel
    assert torch.equal(cuda_probes.fma_sweep_cuda(x, 64, 8), cuda_probes.fma_rate_cuda(x, 64))


@pytest.mark.parametrize(("nchain", "depth"), [(1, 64), (4, 256), (8, 1024)])
def test_sweep_elop_formula_is_the_scripts(nchain, depth):
    """vpu_rate_sweep.py:71-73: depth FMAs at 2 el-ops, nchain start
    multiplies, nchain − 1 merge adds — the el-op counter's count of the
    plain version, with each FMA as its multiply and add."""
    rows, cols = 4, 8
    want = rows * cols * (2 * (depth // nchain) * nchain + 2 * nchain - 1)
    assert vpu_rate_sweep.elops_per_launch(rows, cols, nchain, depth) == want
    counted, _ = profiling.collect_elops(cuda_probes.fma_rate_plain, torch.ones((rows, cols)),
                                         depth, nchain)
    assert counted == want


def test_sweep_grid_is_the_scripts():
    assert vpu_rate_sweep.BLOCK_THREADS == {8: 64, 32: 256, 256: 1024}
    assert vpu_rate_sweep.DEPTHS == (64, 256, 1024)
    assert cuda_probes.FMA_SWEEP_CHAINS == (1, 4, 8)


# --- C5e, C5f: the geometry twin ------------------------------------------------------


def _np_twin(chan, shared, i8, h, n_out):
    """The twin's sum in NumPy float32: each input at its cell and at the
    clamped rows i ± h, in table order."""
    c, x_rows = chan[0].reshape(-1, *chan[0].shape[-2:]).shape[:2]
    rows = np.arange(x_rows)
    lo, hi = np.clip(rows - h, 0, x_rows - 1), np.clip(rows + h, 0, x_rows - 1)
    acc = np.zeros((c, x_rows, chan[0].shape[-1]), np.float32)
    for a in [*chan, *shared, *(m.astype(np.float32) for m in i8)]:
        a = a.reshape(-1, *a.shape[-2:])
        acc = acc + a
        if h:
            acc = acc + a[:, lo]
            acc = acc + a[:, hi]
    return [acc.reshape(chan[0].shape)] * n_out


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h", [0, 1, 8])
def test_geometry_twin_plain_matches_numpy(h, channels):
    rng = np.random.default_rng(h + channels)
    x_rows, y_cols = 20, 12
    lead = (channels,) if channels > 1 else ()
    chan = [rng.standard_normal((*lead, x_rows, y_cols)).astype(np.float32) for _ in range(3)]
    shared = [rng.standard_normal((x_rows, y_cols)).astype(np.float32)]
    i8 = [rng.integers(-3, 4, (x_rows, y_cols)).astype(np.int8) for _ in range(2)]
    ops = cuda_probes.GeometryOperands([torch.from_numpy(a) for a in chan],
                                       shared_in=[torch.from_numpy(a) for a in shared],
                                       i8_in=[torch.from_numpy(a) for a in i8], n_out=2, h=h)
    got = cuda_probes.geometry_twin_cuda(ops)
    assert ops.channels == channels and len(got) == 2
    for g, r in zip(got, _np_twin(chan, shared, i8, h, 2)):
        np.testing.assert_array_equal(g.numpy(), r)
    assert ops.nbytes == (4 * (3 + 2) * channels + 4 + 2) * x_rows * y_cols


def test_geometry_twin_refuses_bad_operands():
    a = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="an output"):
        cuda_probes.GeometryOperands([a], n_out=0)
    with pytest.raises(ValueError, match="shape"):
        cuda_probes.GeometryOperands([a, torch.zeros((8, 5))])
    with pytest.raises(TypeError, match="dtype"):
        cuda_probes.GeometryOperands([a], i8_in=[a])
    with pytest.raises(ValueError, match="block_rows"):
        cuda_probes.GeometryOperands([a], block_rows=64)


@pytest.mark.parametrize("section", dma_geometry_sweep.SECTIONS)
def test_sweep_section_bytes_match_the_operands(section):
    """Each section's byte formula (each operand once) equals the bytes of
    the operands make_case builds, and every case's twin matches its NumPy
    sum on a small grid."""
    x, y = 16, 8
    cases = dma_geometry_sweep.sections(x, y)[section]
    assert cases
    for label, kw in cases:
        ops = dma_geometry_sweep.make_case(**kw, device="cpu")
        assert ops.nbytes == dma_geometry_sweep.case_bytes(**kw), label
        want = dma_geometry_sweep.case_bytes(**kw)
        out_planes = kw.get("n_out", 1) * (kw.get("n_in", 1) if kw.get("packed_out") else 1)
        assert want == 4 * kw["x"] * kw["y"] * kw.get("channels", 1) * (kw.get("n_in", 1)
                                                                         + out_planes)
        got = cuda_probes.geometry_twin_cuda(ops)
        chan = [t.numpy() for t in ops.chan_in]
        for g, r in zip(got, _np_twin(chan, [], [], ops.h, len(ops.outs))):
            np.testing.assert_array_equal(g.numpy(), r, err_msg=label)


def test_sweep_sections_keep_the_scripts_names_and_bigcopy_sizes():
    assert dma_geometry_sweep.SECTIONS == (
        "incount", "rows", "lanes", "triples", "outs", "cgrid", "packed", "windows", "mixes",
        "cgrid2d", "bigcopy", "folded", "merged")
    big = dma_geometry_sweep.sections(3200, 1600)["bigcopy"]
    mb = [dma_geometry_sweep.case_bytes(**kw) / 1e6 for _, kw in big]
    assert [round(m) for m in mb] == [41, 82, 164, 328, 655, 102, 410, 819]
    packed = dict(dma_geometry_sweep.sections(3200, 1600)["packed"])
    ops = dma_geometry_sweep.make_case(**{**packed["packed P=6"], "x": 16, "y": 8}, device="cpu")
    # one (P, X, Y) tensor read through P offsets, one (P, X, Y) tensor written
    assert len({t.untyped_storage().data_ptr() for t in ops.chan_in}) == 1
    assert len({t.untyped_storage().data_ptr() for t in ops.outs}) == 1


def test_bench_geometries_match_the_dye_phase_mix():
    """Geometries 1–3 are the cip_dye_phase mix (its registered bytes) at
    reaches 1, 0 and 8; the packed one reads 23 float planes and a mask and
    writes one (18, X, Y) tensor."""
    res = 8
    want = profiling.mix_bytes("cip_dye_phase", 2 * res, res)
    reach = {"dye_mix_h1": 1, "dye_mix_h0": 0, "element": 8}
    for name, h in reach.items():
        ops = dma_geometry_bench.geometry(name, res, "cpu")
        assert (ops.nbytes, ops.h, ops.channels) == (want, h, 3), name
        assert (len(ops.chan_in), len(ops.shared_in), len(ops.i8_in), len(ops.outs)) == (7, 2, 3, 6)
    ops = dma_geometry_bench.geometry("packed", res, "cpu")
    assert (len(ops.chan_in), len(ops.i8_in), len(ops.outs), ops.h) == (23, 1, 18, 8)
    assert ops.nbytes == (4 * 23 + 1 + 4 * 18) * 2 * res * res


# --- C5g: the row window --------------------------------------------------------------


def _np_row_window(a: np.ndarray, t: int, h: int) -> np.ndarray:
    """dma_rowwin_1600_check.py's kernel in NumPy: each tile's window of
    t + 2h rows from the clamped row, the edge tiles realigned in place."""
    x_rows = a.shape[0]
    n_t = x_rows // t
    out = np.empty_like(a)
    for i in range(n_t):
        rs = int(np.clip(i * (t // h) - 1, 0, (x_rows - t) // h - 2)) * h
        win = a[rs:rs + t + 2 * h].copy()
        if i == 0:
            win[h:] = win[:-h].copy()
            win[:h] = win[h]
        if i == n_t - 1:
            win[:-h] = win[h:].copy()
            win[-h:] = win[-h - 1]
        out[i * t:(i + 1) * t] = win[h:h + t] * np.float32(2.0)
    return out


@pytest.mark.parametrize(("x_rows", "t"), [(64, 16), (64, 8), (48, 24), (3200, 16)])
def test_row_window_plain_matches_numpy(x_rows, t):
    """The plain windows realign the edge tiles as the script does, and the
    whole is 2·a to the bit."""
    a = np.random.default_rng(t).standard_normal((x_rows, 8)).astype(np.float32)
    got = cuda_probes.row_window_cuda(torch.from_numpy(a), t).numpy()
    np.testing.assert_array_equal(got, _np_row_window(a, t, 8))
    np.testing.assert_array_equal(got, 2.0 * a)


def test_row_window_tile_fits_shared_memory():
    assert cuda_probes.row_window_tile(3200, 1600) == 16
    assert (16 + 16) * 1600 * 4 == 204_800 <= cuda_probes.ROW_WINDOW_SMEM
    assert (32 + 16) * 1600 * 4 == 307_200 > cuda_probes.ROW_WINDOW_SMEM  # the TPU's t = 32
    assert cuda_probes.row_window_tile(3200, 4096) is None
    with pytest.raises(ValueError, match="do not tile"):
        cuda_probes.row_window_cuda(torch.zeros((64, 8)), 24)


def _replay(a: np.ndarray, t: int, h: int, slots: int, grid: int, landing: str = "in_order",
            ring: int | None = None, early_release: bool = False,
            skip_halo: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """row_window_schedule run block by block as the kernel's three agents
    taking turns: the producer issues group seq into its slot once the
    slot's `empty` barrier shows seq − slots released; the copy engine lands
    one group in flight (`landing`: the oldest first, "in_order"; the oldest
    stored group before any halo group, "halo_last"; any, "random"); the
    consumers wait on each group's `full` phase, store 2· the tile's groups
    and release each group. Turns go to the first agent that can move:
    producer, engine, consumers ("in_order"), consumers, producer, engine
    ("halo_last"), or at random. Each barrier counts its completed phases,
    and a wait on phase k returns once that count's lowest bit differs from
    k's, so a wait on a barrier a phase behind returns at once, as on the
    card. Controls: a ring of `ring` < `slots` groups (slot s's rows at
    s % ring); `early_release` (a group released as it lands, before its
    stores); `skip_halo` (consumers neither wait on nor release halo groups,
    and the producer refills a halo's slot once the halo lands). Returns
    the output (NaN where nothing was stored) and the times each row was
    stored; raises AssertionError on a deadlock."""
    x_rows, y_cols = a.shape
    ring = slots if ring is None else ring
    rng = np.random.default_rng(x_rows * t + slots)
    out = np.full_like(a, np.nan)
    stores = np.zeros(x_rows, int)
    for groups in cuda_probes.row_window_schedule(x_rows, t, h, slots, grid):
        mem = np.full((ring, h, y_cols), np.nan, np.float32)
        full, empty = [0] * slots, [0] * slots  # completed phases
        producer_waits = [0] * slots  # skip_halo: the producer's own `empty` phase a slot
        in_flight, issued, done, stage = [], 0, 0, "wait"

        def passes(count, seq):  # mbarrier.try_wait.parity for group seq's phase
            return (count & 1) != ((seq // slots) & 1)

        def produce():
            nonlocal issued
            if issued == len(groups):
                return False
            seq, s = issued, issued % slots
            if seq >= slots:
                if not skip_halo:
                    if not passes(empty[s], seq - slots):
                        return False
                elif not groups[seq - slots][4]:  # a halo: its landing releases it
                    if not passes(full[s], seq - slots):
                        return False
                else:
                    if (empty[s] & 1) == (producer_waits[s] & 1):
                        return False
                    producer_waits[s] += 1
            in_flight.append(seq)
            issued += 1
            return True

        def land():
            if not in_flight:
                return False
            if landing == "random":
                k = int(rng.integers(len(in_flight)))
            elif landing == "halo_last":
                k = next((k for k, j in enumerate(in_flight) if groups[j][4]), 0)
            else:
                k = 0
            seq = in_flight.pop(k)
            _, _, s, row, _ = groups[seq]
            mem[s % ring] = a[row:row + h]
            full[s] += 1
            return True

        def consume():
            nonlocal done, stage
            if done == len(groups):
                return False
            _, seq, s, row, stored = groups[done]
            if skip_halo and not stored:
                done += 1
                return True
            if stage == "wait":
                if not passes(full[s], seq):
                    return False
                stage = "store"
                if early_release:
                    empty[s] += 1
                return True
            if stored:
                out[row:row + h] = mem[s % ring] * np.float32(2.0)
                stores[row:row + h] += 1
            if not early_release:
                empty[s] += 1
            done, stage = done + 1, "wait"
            return True

        agents = {"in_order": (produce, land, consume),
                  "halo_last": (consume, produce, land)}.get(landing)
        while done < len(groups) or in_flight or issued < len(groups):
            order = agents or rng.permutation([produce, land, consume])
            if not any(agent() for agent in order):
                raise AssertionError(f"deadlock at group {done} of {len(groups)}")
    return out, stores


ROW_WINDOW_CASES = [(64, 16, 16, 4), (64, 16, 8, 3), (48, 8, 24, 5), (3200, 4, 16, 4),
                    (256, 64, 128, 32), (256, 64, 8, 32)]  # (X, Y, t, slots)
LANDINGS = ["in_order", "halo_last", "random"]


@pytest.mark.parametrize("landing", LANDINGS)
@pytest.mark.parametrize("grid", ["one", "fewer", "more"])
@pytest.mark.parametrize(("x_rows", "y_cols", "t", "slots"), ROW_WINDOW_CASES)
def test_row_window_schedule_replays_to_2a(x_rows, y_cols, t, slots, grid, landing):
    """The persistent kernel's schedule, replayed with the copies landing
    in issue order, halo groups last, and at random, stores every row once
    and gives 2·a to the bit, with one block, fewer blocks than tiles and
    more; each tile's groups are its clamped window (_window_rows), in
    order."""
    h, n_t = 8, x_rows // t
    a = np.random.default_rng(x_rows + t).standard_normal((x_rows, y_cols)).astype(np.float32)
    blocks = {"one": 1, "fewer": max(1, n_t // 3), "more": n_t + 5}[grid]
    out, stores = _replay(a, t, h, slots, blocks, landing)
    np.testing.assert_array_equal(out, 2.0 * a)
    assert (stores == 1).all()
    windows = cuda_probes._window_rows(x_rows, t, h).numpy()
    for groups in cuda_probes.row_window_schedule(x_rows, t, h, slots, blocks):
        for k, (tile, seq, slot, row, _) in enumerate(groups):
            assert (seq, slot, row) == (k, k % slots, windows[tile][(k % (t // h + 2)) * h])


@pytest.mark.parametrize(("x_rows", "y_cols", "t", "slots"), ROW_WINDOW_CASES)
def test_row_window_replay_sees_a_short_ring_and_an_early_release(x_rows, y_cols, t, slots):
    """Controls, with one block so that its ring wraps: a ring one group
    short of the schedule's slots (two slots share one), or a group's slot
    released when it lands, lets the producer overwrite rows before they
    are stored."""
    a = np.random.default_rng(t).standard_normal((x_rows, y_cols)).astype(np.float32)
    assert x_rows // t * (t // 8 + 2) > slots
    short, _ = _replay(a, t, 8, slots, 1, ring=slots - 1)
    early, _ = _replay(a, t, 8, slots, 1, early_release=True)
    assert not np.array_equal(short, 2.0 * a)
    assert not np.array_equal(early, 2.0 * a)


@pytest.mark.parametrize(("x_rows", "y_cols", "t", "slots"), ROW_WINDOW_CASES)
def test_row_window_replay_sees_consumers_that_skip_halo_groups(x_rows, y_cols, t, slots):
    """Control: consumers that skip the halo groups, the producer refilling
    a halo's slot once it lands, give 2·a while the copies land in issue
    order, but where a stored group refills a halo's slot and the halo
    lands last, the consumers' wait on it meets the barrier a phase behind
    and returns before the rows are there: wrong rows, or a release counted
    in the wrong phase and a producer that waits for ever. The kernel's consumers wait on
    and release every group (test_row_window_schedule_replays_to_2a)."""
    a = np.random.default_rng(t).standard_normal((x_rows, y_cols)).astype(np.float32)
    groups = cuda_probes.row_window_schedule(x_rows, t, 8, slots, 1)[0]
    refilled = any(not groups[j - slots][4] and groups[j][4] for j in range(slots, len(groups)))
    in_order, _ = _replay(a, t, 8, slots, 1, "in_order", skip_halo=True)
    np.testing.assert_array_equal(in_order, 2.0 * a)
    try:
        halo_last, _ = _replay(a, t, 8, slots, 1, "halo_last", skip_halo=True)
        wrong = not np.array_equal(halo_last, 2.0 * a)
    except AssertionError:  # a release counted in the wrong phase: the producer waits for ever
        wrong = True
    assert wrong == refilled


def test_row_window_ring_holds_a_window():
    """Four groups of 8 rows of 1600 floats, each with its two barriers,
    fill a block: exactly the t = 16 window; at Y = 4096 not even t = 8's."""
    assert cuda_probes.row_window_slots(1600) == 4
    assert 4 * (8 * 1600 * 4 + 16) <= cuda_probes.ROW_WINDOW_SMEM < 5 * (8 * 1600 * 4 + 16)
    assert cuda_probes.row_window_slots(4096) == 1
    assert cuda_probes.row_window_tile(256, 64) == 128  # 18 groups ≤ 112 slots


def test_rowwin_check_prints_t_and_does_not_fit():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = dma_rowwin_1600_check.check(4096, device="cpu")
    assert res == {"y": 4096, "t": None, "fits": False}
    assert "does not fit" in out.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dma_rowwin_1600_check.main(["1600", "--device", "cpu", "--iters", "1"])
    assert "t=16" in out.getvalue() and "204800 bytes" in out.getvalue()
    assert "values OK" in out.getvalue()


# --- C6: the el-op counter's toys -----------------------------------------------------


@pytest.mark.parametrize("shape", [(32, 128), (8, 128)])
@pytest.mark.parametrize("op", cuda_probes.TOY_OPS)
def test_toy_plain_matches_numpy(op, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = cuda_probes.toy_elementwise_cuda(torch.from_numpy(x), op).numpy()
    want = {"mul2add1": x * np.float32(2.0) + np.float32(1.0), "div3": x / np.float32(3.0),
            "mul3": x * np.float32(3.0)}[op]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="op"):
        cuda_probes.toy_elementwise_cuda(torch.from_numpy(x), "div2")


def test_elop_counter_on_the_toys():
    """tests/test_profiling.py:143 and :168 on the port's counter: the x·2 + 1
    toy on (32, 128) is 2 el-ops an element (2·8·128·4), and the division toy
    weighs more than the multiplication toy."""
    total, per_kernel = profiling.collect_elops(cuda_probes.toy_elementwise_cuda,
                                                torch.ones((32, 128)), "mul2add1")
    assert total == 2 * 8 * 128 * 4 and per_kernel == {}
    x = torch.ones((8, 128))
    div, _ = profiling.collect_elops(cuda_probes.toy_elementwise_plain, x, "div3")
    mul, _ = profiling.collect_elops(cuda_probes.toy_elementwise_plain, x, "mul3")
    assert div > mul > 0


# --- the scripts' entry points --------------------------------------------------------


@pytest.mark.parametrize(("module", "argv"), [
    (vpu_rate_sweep, ["--rows", "4", "--cols", "32", "--iters", "1"]),
    (dma_geometry_sweep, ["--res", "8", "--iters", "1", "--only", "incount,rows"]),
    (dma_geometry_bench, ["--res", "16", "--iters", "1"]),
    (dma_rowwin_1600_check, ["1600", "--iters", "1"]),
], ids=["vpu_rate_sweep", "dma_geometry_sweep", "dma_geometry_bench", "dma_rowwin_1600_check"])
def test_script_needs_a_card_unless_asked_for_the_cpu(module, argv, capsys):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        module.main(argv)
    module.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu" in out


def test_sweep_prints_every_case_and_best(capsys):
    res = vpu_rate_sweep.sweep(rows=4, cols=32, iters=1, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(res["cases"]) == 27 and len(lines) == 28
    assert lines[-1].startswith("BEST: ") and res["best"]["tag"] in lines[-1]
    assert set(res["checks"]) == {f"chains={n} depth={d}" for n in (1, 4, 8)
                                  for d in (64, 256, 1024)}


def test_geometry_sweep_rejects_an_unknown_section():
    with pytest.raises(SystemExit):
        dma_geometry_sweep.main(["--device", "cpu", "--only", "incount,bogus"])
