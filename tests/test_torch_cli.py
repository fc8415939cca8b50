"""The port's CLI (``python -m fluid2d_tpu_torch.cli``) on the CPU: the
cases of tests/test_cli.py (typed-flag tracking, a re-passed default on
resume, the bc override note, the GIF end to end, notes dedupe), the
``--abort-on-nan`` rule that keeps the last good checkpoint, the dump
named by the continued step count, the card as the default device (it
raises without one, never running on the CPU unasked), the flags it does
not offer; and the slice as a whole: both CLIs ``--resume`` from one
seeded JAX checkpoint for 4 steps with ``--dump-fields`` (the JAX CLI with
``-cpu --kernels xla``, the port's with ``--device cpu``), the dumps within
2e-5·max|field|."""

import numpy as np
import pytest
import torch
from PIL import Image

from fluid2d_tpu import cli as jcli
from fluid2d_tpu.utils import io as jio
from fluid2d_tpu_torch import FluidSimulator, cli
from fluid2d_tpu_torch.utils.io import load_checkpoint
from fluid2d_tpu_torch.utils.notes import note_once, reset_notes

from tests.torch_seeded import assert_close_to_scale, jax_seeded_state

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def _run(tmp_path, *argv):
    cli.main([*argv, "--output", str(tmp_path), *CPU])


def test_resolve_args_tracks_typed_flags():
    args = cli.build_parser().parse_args(["-re", "1000000.0", "--steps", "1"])
    typed = cli.resolve_args(args)
    assert "reynolds_num" in typed  # typed AT its default: still explicit
    assert "pressure_iters" not in typed
    assert args.pressure_iters == 2 and args.advection_scheme == "cip"
    assert args.no_dye is False and args.boundary_condition is None
    assert args.device == "cuda" and args.kernels == "auto"
    assert cli.DEFAULTS == jcli.DEFAULTS


def test_resume_repassed_default_applies(tmp_path):
    common = ["-res", "16"]
    ck1 = str(tmp_path / "a.npz")
    _run(tmp_path, "--steps", "2", "--pressure-iters", "4", "--checkpoint", ck1, *common)
    assert load_checkpoint(ck1, "cpu")[1].n_pressure_iter == 4
    ck2 = str(tmp_path / "b.npz")
    _run(tmp_path, "--resume", ck1, "--steps", "1", "--checkpoint", ck2)
    assert load_checkpoint(ck2, "cpu")[1].n_pressure_iter == 4
    ck3 = str(tmp_path / "c.npz")
    _run(tmp_path, "--resume", ck1, "--steps", "1", "--pressure-iters", "2",
         "--checkpoint", ck3)
    _, cfg3, _ = load_checkpoint(ck3, "cpu")
    assert cfg3.n_pressure_iter == 2


def test_resume_overrides_and_fixed_flags(tmp_path, capsys):
    ck = str(tmp_path / "a.npz")
    _run(tmp_path, "-res", "16", "--steps", "2", "--checkpoint", ck)
    capsys.readouterr()
    ck2 = str(tmp_path / "b.npz")
    _run(tmp_path, "--resume", ck, "--steps", "1", "-re", "500", "--dtype", "bfloat16",
         "--kernels", "eager", "-scheme", "kk", "-res", "32", "--checkpoint", ck2)
    out = capsys.readouterr().out
    for flag in ("-scheme", "-res"):
        assert f"note: {flag} cannot change on --resume" in out
    state, cfg, _ = load_checkpoint(ck2, "cpu")
    assert (cfg.re, cfg.dtype, cfg.kernels, cfg.scheme, cfg.resolution) == (
        500.0, "bfloat16", "eager", "cip", 16)
    assert state.v.dtype == torch.bfloat16 and int(state.step) == 3


def test_resume_bc_override_discards_stored_mask_note(tmp_path, capsys):
    sim = FluidSimulator.create(1, 16, mask_image="dragon", scheme="upwind", vor_eps=None,
                                enable_dye=False, device="cpu")
    ck = tmp_path / "mask.npz"
    sim.save(ck)
    capsys.readouterr()
    _run(tmp_path, "--resume", str(ck), "-bc", "2", "--steps", "1")
    out = capsys.readouterr().out
    assert "discarded" in out and "dragon" in out
    assert "Boundary Condition: 2" in out
    _run(tmp_path, "--resume", str(ck), "--steps", "1")
    out = capsys.readouterr().out
    assert "discarded" not in out and "Boundary Condition: dragon" in out


def test_cli_gif_end_to_end(tmp_path):
    gif = tmp_path / "anim.gif"
    _run(tmp_path, "-res", "16", "--steps", "4", "--frame-every", "2", "--gif", str(gif))
    with Image.open(gif) as im:
        assert im.n_frames == 2
    assert sorted(p.name for p in tmp_path.glob("frame_*.png")) == [
        "frame_00000.png", "frame_00001.png"]


def test_gif_without_frames_notes(tmp_path, capsys):
    _run(tmp_path, "-res", "16", "--steps", "1", "--gif", str(tmp_path / "x.gif"))
    assert "no GIF will be written" in capsys.readouterr().out
    assert not (tmp_path / "x.gif").exists()


def test_notes_dedupe(capsys):
    reset_notes()
    note_once("same thing")
    note_once("same thing")
    assert capsys.readouterr().out == "note: same thing\n"


def test_log_lines_and_timing(tmp_path, capsys):
    _run(tmp_path, "-bc", "2", "-res", "16", "--steps", "5", "--log-every", "2")
    out = capsys.readouterr().out.splitlines()
    logs = [line for line in out if line.startswith("step ")]
    assert [line.split(":")[0] for line in logs] == ["step 2", "step 4"]
    assert all("div_rms=" in line and "NaN" not in line for line in logs)
    assert out[-1].startswith("ran 5 steps in ") and out[-1].endswith(" steps/s)")
    assert out[:6] == ["Boundary Condition: 2", "dt: 0.003125", "Re: 1000000.0",
                       "Resolution: 16", "Scheme: cip", "Vorticity confinement: 5.0"]


def test_abort_on_nan_keeps_last_good_checkpoint(tmp_path, capsys):
    ck = tmp_path / "ck.npz"
    _run(tmp_path, "-dt", "0.05", "-res", "32", "-scheme", "upwind", "--steps", "40",
         "--checkpoint", str(ck), "--checkpoint-every", "4", "--abort-on-nan",
         "--dump-fields")
    out = capsys.readouterr().out
    n = int(out.split("** NaN detected at step ")[1].split(";")[0])
    assert n < 40 and f"ran {n} steps" in out
    assert "checkpoint written" not in out  # the final (NaN) state is not saved
    state, _, _ = load_checkpoint(ck, "cpu")
    step = int(state.step)
    assert step % 4 == 0 and step < n
    assert all(torch.isfinite(leaf).all() for leaf in state if leaf is not None)


def test_dump_named_by_continued_step_count(tmp_path):
    ck = str(tmp_path / "a.npz")
    _run(tmp_path, "-res", "16", "--steps", "5", "--checkpoint", ck)
    out = tmp_path / "resumed"
    cli.main(["--resume", ck, "--steps", "3", "--dump-fields", "--output", str(out), *CPU])
    with np.load(out / "step_000008.npz") as data:
        assert set(data.files) == {"v", "p", "dye"}
        assert data["v"].shape == (32, 16, 2) and data["dye"].shape == (32, 16, 3)


def test_dye_vis_needs_dye(tmp_path):
    with pytest.raises(SystemExit):
        _run(tmp_path, "-res", "16", "--steps", "1", "-vis", "3", "-no_dye")


@pytest.mark.parametrize("argv", [["-cpu"], ["--shard", "2"], ["--shard-mesh", "2x1"],
                                  ["--compile-cache", "off"], ["--scoped-vmem", "0"],
                                  ["--kernels", "pallas"], ["--device", "tpu"]])
def test_flags_not_offered(argv, capsys):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)
    assert "error" in capsys.readouterr().err


@pytest.mark.parametrize("device", [[], ["--device", "cuda"]])
def test_card_is_the_default_and_raises_without_one(tmp_path, device):
    if torch.cuda.is_available():
        pytest.skip("checks the card-less refusal")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["-res", "16", "--steps", "1", "--output", str(tmp_path / "o"),
                  "--checkpoint", str(tmp_path / "o" / "c.npz"), "--dump-fields", *device])
    assert not (tmp_path / "o").exists()


def test_both_clis_resume_one_jax_checkpoint(tmp_path):
    """The slice as a whole: one seeded JAX checkpoint, 4 steps in each CLI."""
    res = 24
    jst, _, jcfg = jax_seeded_state(res)
    ck = tmp_path / "seed.npz"
    jio.save_checkpoint(ck, jst, jcfg, {"bc_num": 2, "mask_image": None})
    jcli.main(["--resume", str(ck), "--steps", "4", "--dump-fields", "--output",
               str(tmp_path / "jax"), "-cpu", "--kernels", "xla", "--compile-cache", "off"])
    cli.main(["--resume", str(ck), "--steps", "4", "--dump-fields", "--output",
              str(tmp_path / "port"), *CPU])
    name = "step_000005.npz"  # the seed is one step in: the dump says 1 + 4
    with np.load(tmp_path / "jax" / name) as j, np.load(tmp_path / "port" / name) as t:
        ref, got = dict(j), dict(t)
    assert set(ref) == {"v", "p", "dye"} and np.abs(ref["v"]).max() > 1e-3
    assert_close_to_scale(got, ref)
