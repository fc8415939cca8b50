"""Fixtures: a copy of the benchmark's data at sizes a CPU test can hold."""

from __future__ import annotations

import json
import shutil

import pytest

from bench_port import registry


def shrink(root, res: dict, steps_per_call: int = 6) -> None:
    """Cut the copied configurations to `res` ({config: resolution}) and the
    traffic to short calls and probes, in place."""
    for name, r in res.items():
        path = root / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["resolution"] = r
        path.write_text(json.dumps(cfg))
    for path in (root / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t["trace_seconds"] = 0.2
        t["probes"] = {k: 3 for k in t.get("probes", {})}
        if t["loop"] == "steps":
            t["steps_per_call"] = steps_per_call
        path.write_text(json.dumps(t))


def tiny_copy(tmp_path, steps_per_call: int = 6):
    """The benchmark's folder copied under tmp_path, configurations at
    res 16 (scene 2) and 12 (scene 1)."""
    root = tmp_path / "bench_port"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("tests", "out", "__pycache__"))
    shrink(root, {"cip1600": 16, "upwind400": 12}, steps_per_call)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    """A tiny copy whose steps loops call step(6)."""
    return tiny_copy(tmp_path)


@pytest.fixture(scope="session")
def bench():
    return registry.load_benchmark()
