"""Parts are found by name; a new one is a new file and a new entry."""

from __future__ import annotations

import json

import pytest

from bench_port import registry, run
from bench_port.reference import scenes as ref_scenes


def test_every_cell_finds_its_parts(bench):
    for w in bench["workloads"]:
        cfg = registry.config(w["config"])
        assert cfg["reduced"] == [] and cfg["source"].startswith("https://")
        loop = registry.loop(registry.traffic(w["traffic"])["loop"])
        assert loop.COUNTS in ("steps", "calls") and callable(loop.call)
        for name in registry.traffic(w["traffic"]).get("probes", {}):
            assert callable(registry.probe(name))
        assert set(registry.limits(w["name"])) >= {"state_gap", "last_state_gap", "nonfinite"}
        for traced in (False, True):
            for m in registry.metrics_for(bench, w["name"], traced):
                assert callable(registry.reader(m["name"]))


def test_config_files_are_the_benchmark_files(bench):
    for c in bench["configs"]:
        assert c["file"] == f"bench_port/configs/{c['name']}.json"
        assert registry.config(c["name"])["reduced"] == c["reduced"]


def test_a_fixture_config_traffic_and_metric_added_as_files(tiny_root, bench):
    cfg = registry.config("cip1600", tiny_root)
    (tiny_root / "configs" / "cip24.json").write_text(json.dumps({**cfg, "resolution": 24}))
    (tiny_root / "traffic" / "burst.json").write_text(json.dumps(
        {"loop": "frames", "steps_per_frame": 2, "view": 0, "warm_calls": 1, "trace_seconds": 0.1}))
    (tiny_root / "metrics" / "calls.py").write_text(
        "def read(record):\n    return record.get('calls')\n")
    assert registry.config("cip24", tiny_root)["resolution"] == 24
    assert registry.traffic("burst", tiny_root)["steps_per_frame"] == 2
    assert registry.reader("calls", tiny_root)({"calls": 7}) == 7
    extended = {**bench,
                "workloads": [*bench["workloads"], {"name": "cip24.burst", "config": "cip24",
                                                    "traffic": "burst", "chips": 1, "why": "x"}],
                "end_to_end": [*bench["end_to_end"],
                               {"name": "calls", "unit": "calls", "better": "higher",
                                "bound": 0.1, "source": "host_clock", "workloads": ["cip24.burst"]}]}
    names = [m["name"] for m in registry.metrics_for(extended, "cip24.burst", False)]
    assert sorted(names) == ["calls", "setup_s"]


def test_a_reader_of_its_own_comes_before_the_quantitys(tiny_root):
    (tiny_root / "metrics" / "view_ms.slow.py").write_text("def read(record):\n    return 1.0\n")
    assert registry.reader("view_ms.slow", tiny_root)({"view_s": [0.5]}) == 1.0
    assert registry.reader("view_ms.view", tiny_root)({"view_s": [0.5]}) == 500.0


def test_metric_lists_follow_the_workloads_keys(bench):
    run = {m["name"] for m in registry.metrics_for(bench, "cip1600.run", True)}
    view = {m["name"] for m in registry.metrics_for(bench, "cip1600.view", True)}
    assert "step_roofline" in run and "view_ms.view" in view
    assert not run & view
    for w in bench["workloads"]:
        assert registry.metrics_for(bench, w["name"], True), w["name"]


def test_a_per_layer_metric_without_workloads_follows_what_it_moves(bench):
    extra = {"name": "x.run", "unit": "%", "better": "lower", "source": "device_trace",
             "layer": "device", "moves": "steps_per_s"}
    b = {**bench, "per_layer": [*bench["per_layer"], extra]}
    assert "x.run" in {m["name"] for m in registry.metrics_for(b, "cip1600.run", True)}
    for cell in ("upwind400.run", "cip1600.view"):  # report steps_per_s.host_bound, frames_per_s
        assert "x.run" not in {m["name"] for m in registry.metrics_for(b, cell, True)}


def test_unknown_names_raise(tiny_root, bench):
    with pytest.raises(KeyError):
        registry.cell(bench, "nope.run")
    for fn in (registry.config, registry.traffic, registry.limits, registry.loop,
               registry.probe, registry.reader):
        with pytest.raises(FileNotFoundError):
            fn("nope", tiny_root)


def test_a_traffic_kind_probe_and_scene_added_as_files(tiny_root, bench):
    """A new loop, probe and traffic mix, and a new reference scene, each a
    file of its own under a copy of the folder; the run finds them by name."""
    (tiny_root / "loops" / "halves.py").write_text(
        "from bench_port.session import span\n"
        "COUNTS = 'steps'\n"
        "def steps_per_call(traffic):\n    return 2 * traffic['half']\n"
        "def call(sess, traced):\n"
        "    with span('step_call', traced):\n"
        "        sess.sim.step(sess.traffic['half'])\n"
        "        sess.sim.step(sess.traffic['half'])\n"
        "def numbers(ref, state, traffic, output):\n    return {}\n")
    (tiny_root / "probes" / "halves_seen.py").write_text(
        "def probe(sess, n):\n    return [float(n * sess.k)]\n")
    (tiny_root / "traffic" / "halves.json").write_text(json.dumps(
        {"loop": "halves", "half": 3, "warm_calls": 1, "trace_seconds": 0.2,
         "probes": {"halves_seen": 4}}))
    (tiny_root / "limits" / "cip1600.halves.json").write_text(json.dumps(
        {"state_gap": 0.0, "last_state_gap": 0.0, "nonfinite": 0}))
    (tiny_root / "metrics" / "halves_seen.py").write_text(
        "def read(record):\n    return record['halves_seen'][0] if 'halves_seen' in record else None\n")
    cell = {"name": "cip1600.halves", "config": "cip1600", "traffic": "halves", "chips": 1,
            "why": "x"}
    extended = {**bench, "workloads": [*bench["workloads"], cell],
                "end_to_end": [*bench["end_to_end"],
                               {"name": "steps_per_s.halves", "unit": "steps/s",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["cip1600.halves"]}],
                "per_layer": [*bench["per_layer"],
                              {"name": "halves_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "steps_per_s.halves", "workloads": ["cip1600.halves"]}]}
    plain = run.run_cell(extended, cell, 5, 0.2, False, "cpu", root=tiny_root)
    assert plain["correct"] is True and plain["attempted"] % 6 == 0
    assert set(plain["metrics"]) == {"steps_per_s.halves", "setup_s"}
    traced = run.run_cell(extended, cell, 5, 0.2, True, "cpu", root=tiny_root)
    assert traced["correct"] is True and traced["metrics"]["halves_seen"]["value"] == 24.0

    (tiny_root / "reference" / "scenes" / "bc9.py").write_text(
        "def paint(cv, x_res, y_res):\n"
        "    cv.box((0, 0), (x_res, 2))\n"
        "    cv.mask[:2, 2:] = 2\n    cv.bc[:2, 2:] = (1.0, 0.0)\n")
    drawn = ref_scenes.draw(9, 8, tiny_root / "reference" / "scenes")
    assert drawn["mask"].shape == (16, 8) and (drawn["mask"][:, :2] == 1).all()
    assert (drawn["mask"][:2, 2:] == 2).all() and (drawn["bc"][0, :2, 2:] == 1.0).all()
    assert ref_scenes.derive(drawn["mask"])["pcode"][0, 3] == 9
    with pytest.raises(FileNotFoundError):
        ref_scenes.draw(9, 8)  # not in the folder itself
