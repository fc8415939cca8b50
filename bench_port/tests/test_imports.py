"""The benchmark imports neither JAX nor the JAX package, and its plain
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from bench_port import registry


def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def _top(name: str) -> str:
    return name.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(registry.ROOT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        tops = {_top(n) for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "fluid2d_tpu"}, path


def test_the_yardstick_imports_nothing_of_the_program():
    for path in [*registry.ROOT.rglob("reference/**/*.py"), registry.ROOT / "roofline.py",
                 registry.ROOT / "seeded.py", registry.ROOT / "trace.py",
                 registry.ROOT / "stats.py", *registry.ROOT.glob("metrics/*.py")]:
        assert "fluid2d_tpu_torch" not in {_top(n) for n in _imports(path)}, path


def test_a_cpu_session_loads_no_jax():
    code = ("import sys, json; from bench_port import registry; from bench_port.session import Session;"
            "cfg = {**registry.config('cip1600'), 'resolution': 16};"
            "s = Session(cfg, registry.traffic('view'), 3, 'cpu'); s.checked_call();"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fluid2d_tpu')];"
            "print(json.dumps(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
