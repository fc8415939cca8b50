"""One run of one benchmark cell of the port (``fluid2d_tpu_torch``) on the
card:

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: the cell's configuration and traffic, found by name; the
program's scene and the seeded state on the card; the window's own call
once from that state (kept for the check) and a warm-up; then ``--seconds``
of the traffic; then one more call of the window's kind, from the state the
window left, kept for the check too. With ``--trace 0`` the result holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones, read
from a profiler window and the traffic's probes. Last the program's state
is freed and the plain reference checks both calls (:mod:`bench_port.check`). The last line of standard output is
the result's JSON object; the last lines of standard error are the numbers
checked beside their limits.

Without a card, or with fewer cards than the cell asks for, it exits with
code 2 and prints no result; nothing falls back to the CPU. The program's
kernels build once into its own folder in the checkout
(``fluid2d_tpu_torch/_build/``); the profiler table of a traced run goes to
``bench_port/out/``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

from bench_port import check, registry
from bench_port.session import Session

__all__ = ["drive", "run_cell", "main", "process_age_s"]

_T0 = time.perf_counter()  # fallback origin where /proc is missing
OUT_DIR = registry.ROOT / "out"


def process_age_s() -> float:
    """Seconds since this process started (from /proc: the interpreter's
    start and the imports count)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return time.perf_counter() - _T0


def _power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _number(x):
    """A JSON-safe reading: a non-finite one as its name."""
    return x if isinstance(x, int) or math.isfinite(x) else str(x)


def drive(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool, device,
          root=registry.ROOT, out_file=None) -> tuple[dict, dict, dict]:
    """One run of the program: the checked first call, the warm-up, the
    window (traced or not), the checked last call; then the program freed
    and the reference's numbers. Returns the record, the numbers and the
    device's readings."""
    sess = Session(cfg, traffic, seed, device, root)
    first = sess.checked_call(keep_before=False)  # the reference seeds its own start
    sess.warm(traffic["warm_calls"])
    record = {"loop": traffic["loop"], "config": cfg, "root": str(root),
              "setup_s": process_age_s()}
    if traced:
        record.update(sess.traced(seconds, out_file))
    else:
        record.update(sess.window(seconds))
    last = sess.checked_call()
    nonfinite = sess.nonfinite()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    info = {"platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card else 0}
    record["counts"] = sess.loop.COUNTS
    record["attempted"] = (record["trace"] if traced else record)[sess.loop.COUNTS]
    sess.close()
    numbers = check.reference_numbers(cfg, traffic, seed, first, last, device, root)
    numbers["nonfinite"] = nonfinite
    return record, numbers, info


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, traced: bool, device,
             root=registry.ROOT) -> dict:
    """One run of `cell` on `device`; returns the result object (with the
    checks under ``checks``)."""
    cfg = registry.config(cell["config"], root)
    traffic = registry.traffic(cell["traffic"], root)
    limits = registry.limits(cell["name"], root)
    wanted = registry.metrics_for(bench, cell["name"], traced)
    readers = {m["name"]: registry.reader(m["name"], root) for m in wanted}
    out_file = OUT_DIR / f"{cell['name']}.seed{seed}.profile.txt" if traced else None
    record, numbers, info = drive(cfg, traffic, seed, seconds, traced, device, root, out_file)
    device_info = {"platform": info["platform"], "kind": info["kind"], "count": cell["chips"],
                   "memory_peak_bytes": info["memory_peak_bytes"]}
    if info["platform"] == "gpu":
        device_info["power_limit_w"] = _power_limit_w()
    if traced:
        device_info["busy_s"] = record["trace"]["busy_s"]
        device_info["window_s"] = record["trace"]["window_s"]
    metrics = {}
    for m in wanted:
        value = readers[m["name"]](record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = record["attempted"]
    result = {"correct": check.judge(numbers, limits), "attempted": attempted,
              "failed": attempted if numbers["nonfinite"] else 0, "metrics": metrics,
              "device": device_info}
    if traced:
        result["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                               "idle_gaps": record["trace"]["idle_by_span"][:10]}
    result["checks"] = {name: {"value": _number(numbers.get(name, math.nan)), "limit": lim}
                        for name, lim in limits.items()}
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # One intra-op thread: the run's host work is the launch path, and idle
    # pool threads only take cores from it on a shared host.
    torch.set_num_threads(1)
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell needs {cell['chips']} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible",
          file=sys.stderr)
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
