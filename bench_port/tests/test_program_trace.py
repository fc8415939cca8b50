"""The reduction by the program's own spans from synthetic events, the
program_spans probe's counters, its readers, and the whole traced run on
the CPU with the probe listed in a copy's traffic files and its metrics
added to a copy of the benchmark."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from bench_port import registry, run
from bench_port.program_trace import reduce_program, table

SEED = 2**31 + 1213

EVENTS = [
    ("span", "step_call", 0.0, 10.0),
    ("host", "f2d.step", 1.0, 5.0),
    ("host", "f2d.phase.sor", 2.0, 4.0),
    ("host", "f2d.launch", 3.0, 3.5),
    ("host", "aten::empty", 2.1, 2.2),  # an operator: no program span
    ("host", "f2d.step", 5.0, 9.0),
    ("host", "f2d.phase.sor", 6.0, 8.0),
    ("host", "f2d.launch", 7.0, 7.25),
    ("device", "f2d.step", 3.2, 9.5),  # a span's shadow on the device: not an operation
    ("device", "sor_fused_kernel", 3.4, 3.6),
    ("device", "sor_fused_kernel", 7.1, 7.3),
    ("span", "to_image", 10.0, 14.0),
    ("host", "f2d.to_image.d2h", 10.5, 12.0),
    ("device", "Memcpy DtoH", 11.0, 11.5),
    ("host", "f2d.to_image.convert", 12.0, 13.5),
]

# The per-layer metrics the probe's readers serve, as a benchmark that runs
# the probe would list them.
PROPOSED = [
    ("step_self_us.host_bound", "us", "run loop and launch path", "steps_per_s.host_bound",
     ["upwind400.run"]),
    ("wrapper_self_us.host_bound", "us", "run loop and launch path", "steps_per_s.host_bound",
     ["upwind400.run"]),
    ("enqueue_us.host_bound", "us", "run loop and launch path", "steps_per_s.host_bound",
     ["upwind400.run"]),
    ("launches_per_step.host_bound", "launches", "run loop and launch path",
     "steps_per_s.host_bound", ["upwind400.run"]),
    ("image_d2h_ms.view", "ms", "front end / views", "frames_per_s",
     ["cip1600.view", "upwind400.view"]),
    ("image_convert_ms.view", "ms", "front end / views", "frames_per_s",
     ["cip1600.view", "upwind400.view"]),
    ("d2h_MB_per_frame.view", "MB", "front end / views", "frames_per_s",
     ["cip1600.view", "upwind400.view"]),
]
PROBE_COUNTS = {"run": 20, "view": 30}


def _with_probe(bench):
    return {**bench, "per_layer": [*bench["per_layer"], *(
        {"name": n, "unit": u, "better": "lower", "source": "device_trace", "layer": layer,
         "moves": moves, "workloads": wl} for n, u, layer, moves, wl in PROPOSED)]}


def test_self_time_is_the_duration_less_the_child_program_spans():
    spans = reduce_program(EVENTS)["spans"]
    assert spans["f2d.step"] == {"count": 2, "total_s": pytest.approx(8.0),
                                 "self_s": pytest.approx(4.0)}
    assert spans["f2d.phase.sor"]["self_s"] == pytest.approx(4.0 - 0.75)
    assert spans["f2d.launch"] == {"count": 2, "total_s": pytest.approx(0.75),
                                   "self_s": pytest.approx(0.75)}
    assert spans["f2d.to_image.d2h"]["total_s"] == pytest.approx(1.5)
    assert "aten::empty" not in spans and "step_call" not in spans


def test_idle_time_goes_to_the_innermost_program_span():
    r = reduce_program(EVENTS)
    assert r["window_s"] == pytest.approx(14.0)
    assert r["busy_s"] == pytest.approx(0.2 + 0.2 + 0.5)  # the shadow is not busy
    idle = r["idle_by_span"]
    assert idle["f2d.launch"] == pytest.approx(0.5 - 0.1 + 0.25 - 0.15)
    assert idle["f2d.phase.sor"] == pytest.approx(1.0 + 0.4 + 1.0 + 0.7)
    assert idle["f2d.step"] == pytest.approx(2 * 2.0)
    assert idle["f2d.to_image.d2h"] == pytest.approx(1.0)
    assert idle["f2d.to_image.convert"] == pytest.approx(1.5)
    assert idle["none"] == pytest.approx(1.0 + 1.0 + 0.5 + 0.5)
    assert sum(idle.values()) == pytest.approx(r["window_s"] - r["busy_s"])
    under = r["idle_under"]
    assert under["to_image"] == {"none": pytest.approx(1.0),
                                 "f2d.to_image.d2h": pytest.approx(1.0),
                                 "f2d.to_image.convert": pytest.approx(1.5)}
    assert sum(under["step_call"].values()) == pytest.approx(10.0 - 0.4)
    assert "f2d.step" in table({**r, "calls": 1, "steps": 2})


def test_no_span_raises():
    with pytest.raises(ValueError):
        reduce_program([("device", "k", 0.0, 1.0), ("host", "aten::add", 0.0, 1.0)])


def test_the_probe_reads_counter_deltas_and_turns_spans_off(tmp_path):
    from fluid2d_tpu_torch.utils import trace

    probe = registry.probe("program_spans")
    sim = SimpleNamespace(state=SimpleNamespace(v=torch.zeros(2, 4, 4)),
                          cfg=SimpleNamespace(scheme="upwind", resolution=4))

    def call(traced):
        assert traced
        with trace.span("f2d.step"):
            trace.add_launches({"f2d_sor_iteration": 1, "f2d_confinement": 2})
            trace.to_host(torch.ones(3))  # a CPU tensor: no bytes

    sess = SimpleNamespace(sim=sim, k=5, traffic={"loop": "steps"}, root=tmp_path, call=call)
    trace.add_launches({"f2d_mac_dye_phase": 7})  # before the probe: not counted
    try:
        r = probe(sess, 3)
        assert r["calls"] == 3 and r["steps"] == 15
        assert r["launches"] == {"f2d_sor_iteration": 3, "f2d_confinement": 6}
        assert r["d2h_bytes"] == 0 and r["spans"]["f2d.step"]["count"] == 3
        assert (tmp_path / "out" / "program_spans.upwind4.steps.txt").is_file()
        assert registry.reader("launches_per_step.host_bound")({"program_spans": r}) == 0.6

        def fails(traced):
            raise RuntimeError("in the loop")

        with pytest.raises(RuntimeError):
            probe(SimpleNamespace(**{**vars(sess), "call": fails}), 1)
        assert trace.span("f2d.a") is trace.span("f2d.b")  # spans off again
    finally:
        trace.add_launches({"f2d_sor_iteration": 1, "f2d_confinement": 2}, times=-3)
        trace.add_launches({"f2d_mac_dye_phase": 7}, times=-1)


@pytest.mark.parametrize("name", [n for n, *_ in PROPOSED])
def test_each_reader_gives_none_without_the_probe(name):
    read = registry.reader(name)
    assert read({}) is None
    assert read({"program_spans": None}) is None  # a program without the tracer
    assert read({"trace": {"window_s": 1.0}, "host_step_s": [1e-4]}) is None


def test_readers_on_a_probe_record():
    rec = {"program_spans": {**reduce_program(EVENTS), "calls": 2, "steps": 4,
                             "launches": {"f2d_a": 6, "f2d_b": 2}, "d2h_bytes": 3_000_000}}
    got = {name: registry.reader(name)(rec) for name, *_ in PROPOSED}
    assert got == {"step_self_us.host_bound": pytest.approx(1e6 * 4.0 / 4),
                   "wrapper_self_us.host_bound": pytest.approx(1e6 * 3.25 / 4),
                   "enqueue_us.host_bound": pytest.approx(1e6 * 0.75 / 4),
                   "launches_per_step.host_bound": 2.0,
                   "image_d2h_ms.view": pytest.approx(1e3 * 1.5 / 2),
                   "image_convert_ms.view": pytest.approx(1e3 * 1.5 / 2),
                   "d2h_MB_per_frame.view": 1.5}


@pytest.mark.parametrize("with_probe", [False, True])
def test_every_cell_a_per_layer_metric_lists_reports_what_it_moves(bench, with_probe):
    b = _with_probe(bench) if with_probe else bench
    for m in b["per_layer"]:
        for cell in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in registry.metrics_for(b, cell, False)}, (
                m["name"], cell)
            assert m in registry.metrics_for(b, cell, True)


@pytest.mark.parametrize("name", ["upwind400.run", "cip1600.view"])
def test_a_traced_run_with_the_probe_reports_the_new_metrics(bench, tiny_root, name):
    """The probe listed in a copy's traffic files, as a benchmark that runs
    it would list it: the traced run's line holds every new metric of the
    cell but the launch path's enqueue time; on the CPU no kernel launches
    and no byte crosses from a card."""
    for traffic, n in PROBE_COUNTS.items():
        path = tiny_root / "traffic" / f"{traffic}.json"
        t = json.loads(path.read_text())
        t["probes"]["program_spans"] = n
        path.write_text(json.dumps(t))
    b = _with_probe(bench)
    r = run.run_cell(b, registry.cell(b, name), SEED, 0.2, True, "cpu", root=tiny_root)
    assert r["correct"] is True
    # the CPU takes the plain versions: no launch span to read
    new = {n for n, *_, wl in PROPOSED if name in wl} - {"enqueue_us.host_bound"}
    assert new <= set(r["metrics"])
    for n in new:
        value = r["metrics"][n]["value"]
        assert value == 0 if n.startswith(("launches", "d2h")) else value > 0, n
    loop = "steps" if name.endswith(".run") else "frames"
    scheme = "upwind" if name.startswith("upwind") else "cip"
    assert list((tiny_root / "out").glob(f"program_spans.{scheme}*.{loop}.txt"))
