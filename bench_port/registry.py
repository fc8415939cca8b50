"""Where the benchmark finds its parts, by the names ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: a configuration (the scene, the simulator
  settings, where they come from);
- ``traffic/<traffic>.json``: a traffic mix, the parameters of a loop and
  the probes of a traced run;
- ``loops/<loop>.py``: a loop, the program's calls as a user makes them
  (``steps_per_call(traffic)``, ``call(session, traced)``,
  ``numbers(ref, state, traffic, output)`` for the check, ``COUNTS``);
- ``probes/<probe>.py``: a probe of a traced run, ``probe(session, n)``,
  whose readings go into the run's record under its name;
- ``reference/scenes/bc<n>.py``: the plain reference's scene ``n``;
- ``limits/<cell>.json``: the limit of each number the check compares in
  that cell;
- ``metrics/<metric>.py``: a metric's reader, ``read(record)``, which
  returns the metric's value from a run's record, or None where the record
  holds nothing for it. A metric named ``<quantity>.<part>`` (the same
  quantity reported apart for some cells) takes ``metrics/<quantity>.py``
  when it has no file of its own.

A new configuration, traffic mix, loop, probe, scene, cell or metric is a
new file here and a new entry in ``BENCHMARK.json``; no existing file
changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "REPO", "load_benchmark", "cell", "config", "traffic", "limits",
           "loop", "probe", "reader", "metrics_for"]

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_benchmark(repo: Path = REPO) -> dict:
    return json.loads((Path(repo) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    msg = f"no workload {name!r} in BENCHMARK.json (have: {[w['name'] for w in bench['workloads']]})"
    raise KeyError(msg)


def _json(root: Path, folder: str, name: str) -> dict:
    path = Path(root) / folder / f"{name}.json"
    if not path.is_file():
        msg = f"no file {path} for {name!r}"
        raise FileNotFoundError(msg)
    return json.loads(path.read_text())


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root, "traffic", name)


def limits(cell_name: str, root: Path = ROOT) -> dict:
    return _json(root, "limits", cell_name)


def _module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"bench_port_{tag}_" + path.stem.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _py(root: Path, folder: str, name: str) -> Path:
    path = Path(root) / folder / f"{name}.py"
    if not path.is_file():
        msg = f"no file {path} for {name!r}"
        raise FileNotFoundError(msg)
    return path


def loop(name: str, root: Path = ROOT):
    """The module ``loops/<name>.py``."""
    return _module(_py(root, "loops", name), "loop")


def probe(name: str, root: Path = ROOT):
    """The ``probe`` function of ``probes/<name>.py``."""
    return _module(_py(root, "probes", name), "probe").probe


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``, or else of
    ``metrics/<quantity>.py`` for a name ``<quantity>.<part>``."""
    folder = Path(root) / "metrics"
    path = folder / f"{name}.py"
    if not path.is_file():
        path = folder / f"{name.split('.')[0]}.py"
    if not path.is_file():
        msg = f"no reader {folder / name}.py for metric {name!r}"
        raise FileNotFoundError(msg)
    return _module(path, "metric").read


def metrics_for(bench: dict, cell_name: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with tracing its per-layer ones. A metric with a ``workloads`` list
    belongs to those cells; a per-layer metric without one to every cell
    that reports the end-to-end metric it moves."""
    def mine(m):
        return cell_name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if mine(m) is not False]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    out = []
    for m in bench["per_layer"]:
        hit = mine(m)
        if hit or (hit is None and m["moves"] in moved):
            out.append(m)
    return out
