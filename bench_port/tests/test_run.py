"""A whole run on the CPU at a tiny size, the card's look skipped: the last
line's keys, the check passing on the sound program, and failing with the
timed path broken underneath or with the bf16 control in its place."""

from __future__ import annotations

import json
import math

import pytest
import torch

import fluid2d_tpu_torch.models.cip as prog_cip
import fluid2d_tpu_torch.models.mac as prog_mac
import fluid2d_tpu_torch.utils.viz as prog_viz
from bench_port import control, registry, run
from bench_port.tests.conftest import tiny_copy
from fluid2d_tpu_torch.models.simulator import FluidSimulator

SEED = 2**31 + 977  # more than 32 signed bits hold
CELLS = ["cip1600.run", "upwind400.run", "cip1600.view", "upwind400.view"]


def _run(bench, name, root, traced=False):
    return run.run_cell(bench, registry.cell(bench, name), SEED, 0.2, traced, "cpu", root=root)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_is_correct_and_has_the_keys(bench, tiny_root, name, traced):
    r = _run(bench, name, tiny_root, traced)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == set(registry.limits(name, tiny_root))
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    wanted = {m["name"] for m in registry.metrics_for(bench, name, traced)}
    # the CPU has no device trace: the roofline reader finds nothing to read
    assert set(r["metrics"]) == wanted - {"step_roofline"}
    for m in r["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(r["breakdown"]["idle_gaps"]) <= 10
    json.loads(json.dumps(r))


def test_without_a_card_the_command_fails_and_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "cip1600.run", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


# -- faults planted in the program: each must turn `correct` false ------------------

def _frozen(monkeypatch):
    """A step that returns its state unchanged."""
    monkeypatch.setattr(FluidSimulator, "step", lambda self, n=1: None)


def _half(monkeypatch):
    """Half of the grid left out: its rows keep their values of before."""
    real = FluidSimulator.step

    def step(self, n=1):
        before = self.state
        real(self, n)
        half = before.v.shape[-2] // 2
        leaves = []
        for old, new in zip(before, self.state):
            if new is not None and new.dim() >= 2:
                new = new.clone()
                new[..., half:, :] = old[..., half:, :]
            leaves.append(new)
        self.state = type(self.state)(*leaves)

    monkeypatch.setattr(FluidSimulator, "step", step)


def _poke(monkeypatch):
    """One value altered where it is produced: the first phase's velocity
    at one cell (CIP) or the MAC velocity phase's."""
    def poked(fn):
        def wrapped(*args, **kw):
            out = list(fn(*args, **kw))
            v = out[0].clone()
            v[0, v.shape[1] // 2, v.shape[2] // 2] += 0.05
            out[0] = v
            return tuple(out)
        return wrapped

    monkeypatch.setattr(prog_cip, "cip_velocity_phase_cuda", poked(prog_cip.cip_velocity_phase_cuda))
    monkeypatch.setattr(prog_mac, "mac_velocity_phase_cuda", poked(prog_mac.mac_velocity_phase_cuda))


def _stale_frame(monkeypatch):
    """The frame of the state before the frame's steps."""
    real = FluidSimulator.step

    def step(self, n=1):
        self._before = self.state
        real(self, n)

    monkeypatch.setattr(FluidSimulator, "step", step)
    monkeypatch.setattr(FluidSimulator, "render",
                        lambda self, vis=0: self._render(self._before, self.scene, vis))


def _pixel_block(monkeypatch):
    """An 8×8 block of the image altered where the image is made."""
    real = prog_viz.to_image

    def to_image(rgb):
        img = real(rgb).copy()
        img[:8, :8] = 255 - img[:8, :8]
        return img

    monkeypatch.setattr(prog_viz, "to_image", to_image)


def _stale_after_warmup(monkeypatch):
    """A run loop that goes wrong once it has warmed up, as a replayed
    capture with a stale buffer would: from the third call on, each call
    steps as it should but hands back the velocity of before the call."""
    real = FluidSimulator.step

    def step(self, n=1):
        self._calls = getattr(self, "_calls", 0) + 1
        before = self.state
        real(self, n)
        if self._calls > 2:
            self.state = self.state._replace(v=before.v.clone())

    monkeypatch.setattr(FluidSimulator, "step", step)


FAULTS = {"frozen": _frozen, "half": _half, "poke": _poke, "stale_frame": _stale_frame,
          "pixel_block": _pixel_block, "stale_after_warmup": _stale_after_warmup}


FRAME_FAULTS = ("stale_frame", "pixel_block")  # only a frame loop has a frame


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS
                                        if c.endswith(".view") or f not in FRAME_FAULTS])
def test_a_broken_timed_path_is_not_correct(bench, tiny_root, monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    r = _run(bench, name, tiny_root)
    assert r["correct"] is False
    failed = [k for k, c in r["checks"].items()
              if not isinstance(c["value"], (int, float)) or math.isnan(c["value"])
              or c["value"] > c["limit"]]
    assert failed, r["checks"]
    if fault == "stale_after_warmup":  # the first call is sound: only the last call sees it
        assert r["checks"]["state_gap"]["value"] == 0
        assert "last_state_gap" in failed


@pytest.mark.parametrize("name", CELLS)
def test_the_bf16_control_is_not_correct(bench, tmp_path, name):
    """The control at a tiny grid but the traffic's own calls (step(100) in
    a steps loop): the limits were set from such calls."""
    tiny_root = tiny_copy(tmp_path, registry.traffic("run")["steps_per_call"])
    limits = registry.limits(name, tiny_root)
    rows = list(control.readings(name, "bfloat16", [SEED, 5, 6], "cpu", 0.2, root=tiny_root,
                                 bench=bench))
    for row in rows:
        numbers = {k: row[k] for k in limits if k in row}
        numbers["nonfinite"] = 0
        assert not run.check.judge(numbers, limits), row
    sound = list(control.readings(name, "float32", [SEED], "cpu", 0.2, root=tiny_root,
                                  bench=bench))
    assert sound[0]["state_gap"] == 0 and sound[0]["last_state_gap"] == 0
