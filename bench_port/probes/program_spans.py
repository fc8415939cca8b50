"""program_spans: the program's own spans and counters
(``fluid2d_tpu_torch/utils/trace.py``) over `calls` calls of the cell's
loop, each with the benchmark's spans, and a synchronize, in a profiler
window of their own with the program's spans on.

Returns the reduction of :func:`bench_port.program_trace.reduce_program`
with the calls and steps made and the counters' deltas (``launches`` by
entry point, ``d2h_bytes``), and writes it as a table to the benchmark
folder's ``out/``, named from the session's scheme, resolution and loop.
A program without the tracer gives None."""

import warnings
from pathlib import Path

import torch

from bench_port import program_trace
from bench_port.session import span, sync
from bench_port.trace import events_from_profiler


def probe(sess, calls: int):
    try:
        from fluid2d_tpu_torch.utils import trace as tr
    except ImportError:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if sess.sim.state.v.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync(sess.sim)
    launches0, d2h0 = dict(tr.launches), tr.d2h_bytes
    with warnings.catch_warnings():  # the profiler's note on clearing events at its stop
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        with torch.profiler.profile(activities=acts) as prof:
            with tr.enabled(True):
                for _ in range(calls):
                    sess.call(True)
                with span("sync", True):
                    sync(sess.sim)
    red = program_trace.reduce_program(events_from_profiler(prof))
    red.update(calls=calls, steps=calls * sess.k,
               launches={e: n - launches0.get(e, 0) for e, n in tr.launches.items()
                         if n != launches0.get(e, 0)},
               d2h_bytes=tr.d2h_bytes - d2h0)
    cfg = sess.sim.cfg
    name = f"program_spans.{cfg.scheme}{cfg.resolution}.{sess.traffic['loop']}.txt"
    out = Path(sess.root) / "out" / name
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(program_trace.table(red))
    return red
