"""The port's tracer (``fluid2d_tpu_torch/utils/trace.py``) on the CPU.

With spans off (the default) a step and a frame make no
``record_function``; with spans on, under ``torch.profiler``, each
``f2d.step`` holds its phase wrappers' spans in phase order, and
``to_image`` its copy and its conversion; a MAC phase called with KK opens
``f2d.phase.<name>.kk``. ``enabled`` restores the flag it found, also after
an exception. With the kernel library stood in for by a stub that only
returns, ``launch`` counts a step's launches on the CPU: KK's MAC phases
under their own keys (``<entry>.kk``), each calling its plain entry point,
with the same totals a step as upwind. A CPU tensor adds nothing to the
device→host byte counter; ``add_launches`` adds counts × times. The
counting of ``launch`` itself and of a CUDA frame's bytes needs a card
(``tests/test_torch_cuda.py``). The CLI's ``--profile`` writes a Chrome
trace holding the spans.
"""

import collections
import contextlib
import json

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch import FluidSimulator, cli
from fluid2d_tpu_torch.utils import trace
from fluid2d_tpu_torch.utils.trace import launches
from fluid2d_tpu_torch.utils.viz import to_image

torch.set_num_threads(1)

RES = 16

# (create() keywords, the phase spans of one step in order)
STEPS = {
    "cip": ({"scheme": "cip"}, ["cip_velocity", "confinement", "sor", "cip_dye"]),
    "upwind": ({"scheme": "upwind", "re": 1000.0},
               ["mac_velocity", "confinement", "sor", "mac_dye"]),
    "kk": ({"scheme": "kk", "re": 1000.0}, ["mac_velocity.kk", "confinement", "sor",
                                            "mac_dye.kk"]),
    "kk_jacobi6": ({"scheme": "kk", "re": 1000.0, "pressure_solver": "jacobi",
                    "n_pressure_iter": 6}, ["mac_velocity.kk", "confinement", "jacobi", "jacobi",
                                            "mac_dye.kk"]),
    "cip_sor3_bare": ({"scheme": "cip", "vor_eps": None, "enable_dye": False,
                       "n_pressure_iter": 3}, ["cip_velocity", "sor", "sor"]),
}


def _sim(kind: str) -> FluidSimulator:
    kw, _ = STEPS[kind]
    return FluidSimulator.create(2, RES, device="cpu", **kw)


def _spans(prof) -> list[tuple[float, float, str]]:
    """The program's spans of a CPU profile, (start, end, name) by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.name.startswith("f2d."))


def _inside(spans, outer: str) -> list[list[str]]:
    """For each span named `outer`, the names of the spans within it, in order."""
    return [[n for s, e, n in spans if s0 <= s and e <= e0 and n != outer]
            for s0, e0, n0 in spans if n0 == outer]


def _off() -> bool:
    return trace.span("f2d.a") is trace.span("f2d.b")  # the shared null context


@pytest.mark.parametrize("kind", ["cip", "upwind"])
def test_spans_off_make_no_record_function(monkeypatch, kind):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    sim = _sim(kind)
    assert _off()
    sim.step(3)
    to_image(sim.render(0))
    sim.get_norm_field()
    sim.field_to_numpy()
    with trace.enabled(True), pytest.raises(AssertionError, match="f2d.step"):
        sim.step(1)  # the same path does reach record_function with spans on
    assert _off()


@pytest.mark.parametrize("kind", list(STEPS))
def test_step_span_holds_the_phase_spans_in_order(kind):
    sim = _sim(kind)
    sim.step(1)
    phases = [f"f2d.phase.{p}" for p in STEPS[kind][1]]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.enabled(True):
            sim.step(3)
    assert _off()
    spans = _spans(prof)
    assert _inside(spans, "f2d.step") == [phases] * 3
    assert [n for *_, n in spans if not n.startswith("f2d.phase.")] == ["f2d.step"] * 3


def test_to_image_spans_its_copy_then_its_conversion():
    sim = _sim("cip")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.enabled(True):
            img = to_image(sim.render(0))
    assert img.dtype == np.uint8 and img.shape == (RES, 2 * RES, 3)
    assert [n for *_, n in _spans(prof)] == ["f2d.to_image.d2h", "f2d.to_image.convert"]


def test_enabled_sets_and_restores_the_flag_even_after_an_exception():
    assert _off()
    with pytest.raises(RuntimeError, match="inside"):
        with trace.enabled(True):
            assert not _off()
            with trace.enabled(False):
                assert _off()
            assert not _off()
            raise RuntimeError("inside")
    assert _off()
    trace.enabled(True)
    try:
        assert not _off()
    finally:
        trace.enabled(False)
    assert _off()


def test_cpu_tensors_add_no_device_to_host_bytes(tmp_path):
    sim = _sim("upwind")
    sim.step(2)
    before = trace.d2h_bytes
    to_image(sim.render(0))
    to_image(np.zeros((4, 3, 3), dtype=np.float32))
    for get in (sim.get_norm_field, sim.get_pressure_field, sim.get_vorticity_field,
                sim.get_dye_field, sim.field_to_numpy):
        get()
    sim.save(tmp_path / "c.npz")
    assert trace.d2h_bytes == before


def test_add_launches_adds_counts_times_replays():
    body = {"f2d_mac_velocity_phase": 1, "f2d_sor_iteration": 2}
    before = dict(launches)
    trace.add_launches(body, times=5)
    try:
        assert launches["f2d_mac_velocity_phase"] == before.get("f2d_mac_velocity_phase", 0) + 5
        assert launches["f2d_sor_iteration"] == before.get("f2d_sor_iteration", 0) + 10
        trace.add_launches(body)
        assert launches["f2d_sor_iteration"] == before.get("f2d_sor_iteration", 0) + 12
    finally:
        trace.add_launches(body, times=-6)
    assert {k: n for k, n in launches.items() if n} == {k: n for k, n in before.items() if n}


class _StubLibrary:
    """The kernel library's stand-in: every entry point returns 0 and is
    recorded by name; nothing runs."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            return 0

        return entry


@pytest.fixture
def stub_launches(monkeypatch):
    """The wrappers take their launch path on CPU tensors, into a stub
    library; returns the stub."""
    from types import SimpleNamespace

    from fluid2d_tpu_torch.ops import _build, cuda_phases, cuda_stencil

    lib = _StubLibrary()
    for mod in (cuda_phases, cuda_stencil):
        monkeypatch.setattr(mod, "on_cpu", lambda t, wrapper: False)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return lib


# (create() keywords, the counter's keys a step moves by one each)
COUNTED = {
    "upwind": ({"scheme": "upwind", "re": 1000.0},
               ["f2d_mac_velocity_phase", "f2d_confinement", "f2d_sor_iteration",
                "f2d_mac_dye_phase"]),
    "kk": ({"scheme": "kk", "re": 1000.0},
           ["f2d_mac_velocity_phase.kk", "f2d_confinement", "f2d_sor_iteration",
            "f2d_mac_dye_phase.kk"]),
}


@pytest.mark.parametrize("kind", list(COUNTED))
def test_launch_counts_kk_forms_apart_with_the_same_totals(stub_launches, kind):
    kw, keys = COUNTED[kind]
    sim = FluidSimulator.create(2, RES, device="cpu", **kw)
    before, runs_before = dict(launches), trace.entry_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.enabled(True):
            sim.step(3)
    moved = {k: n - before.get(k, 0) for k, n in launches.items() if n != before.get(k, 0)}
    assert moved == {k: 3 for k in keys}
    assert sum(moved.values()) / 3 == 4  # launches a step, as before the split
    by_entry = {k: n - runs_before[k] for k, n in trace.entry_launches().items()
                if n != runs_before[k]}
    assert by_entry == {k: 3 for k in COUNTED["upwind"][1]}
    assert collections.Counter(stub_launches.called) == by_entry  # the C names, no form
    spans = _spans(prof)
    for key in keys:
        if key.startswith("f2d_mac_"):
            phase = "f2d.phase." + key.removeprefix("f2d_").replace("_phase", "")
            assert _inside(spans, phase) == [["f2d.launch"]] * 3, phase
    assert sum(n == "f2d.launch" for *_, n in spans) == 12


def test_cli_profile_writes_a_chrome_trace_with_the_spans(tmp_path, capsys):
    prof = tmp_path / "prof"
    cli.main(["-bc", "2", "-res", str(RES), "--steps", "4", "--frame-every", "2",
              "--device", "cpu", "--output", str(tmp_path / "out"), "--profile", str(prof)])
    assert f"profile written to {prof / 'trace.json'}" in capsys.readouterr().out
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert names.count("f2d.step") == 4 and names.count("f2d.phase.sor") == 4
    assert names.count("f2d.to_image.d2h") == names.count("f2d.to_image.convert") == 2
    assert _off()
