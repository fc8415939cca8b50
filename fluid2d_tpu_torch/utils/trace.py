"""The port's one tracer: spans of its host time and counters of its work.

Spans. ``with span("f2d.step"):`` marks a piece of the program's host
time. Off (the default) a span site reads one flag and enters a shared null
context: nothing is allocated and no profiler call is made. On
(:func:`enabled`) it enters ``torch.profiler.record_function``, so the
spans land in a running profiler's event list beside the card's operations,
on the same clock, and each idle gap of the device can be put down to the
innermost span the host was in. A span's parent is the span open around it
on the host thread (the program is single-threaded). Every span is named
``f2d.*``:

==========================  ======================================================
``f2d.step``                one time step (``models/cip.py:cip_step``,
                            ``models/mac.py:mac_step``), the whole body
``f2d.phase.<name>``        a kernel wrapper, entry to return, before it routes
                            by device: ``cip_velocity``, ``cip_dye``,
                            ``mac_velocity``, ``mac_dye``, ``confinement``,
                            ``sor``, ``jacobi``, ``cip_advect``; a MAC phase
                            called with KK: ``mac_velocity.kk``,
                            ``mac_dye.kk``
``f2d.launch``              ``ops/launch.py:launch``: library lookup, device
                            guard, stream, the C call, the return code's check
``f2d.graph_replay``        ``models/replay.py``: one replay of a step's CUDA
                            graph (the graph path of ``FluidSimulator.step``,
                            where the three spans above do not open)
``f2d.to_image.convert``    ``utils/viz.py:to_image``: clip, flip, scale, cast to
                            uint8; for a CUDA frame the enqueue of the kernel V1
                            (``ops/cuda_view.py``), before ``d2h``; for a host
                            frame the NumPy passes, after it
``f2d.to_image.d2h``        ``utils/viz.py:to_image``: the wait for the queue and
                            the device→host copy, of the X·Y·3-byte image for a
                            CUDA frame, into a fresh array; for a host frame
                            the frame taken as an array
==========================  ======================================================

Counters, counted whether spans are on or off:

- ``launches[entry]``: kernel-library entry points enqueued, by C entry
  point (``ops/launch.py:launch`` adds one a call; :func:`add_launches`
  adds a replayed graph's); a form of an entry point counted apart has
  its own key, ``<entry>.<form>`` (the MAC phases with KK:
  ``f2d_mac_velocity_phase.kk``, ``f2d_mac_dye_phase.kk``; the Jacobi
  iteration by its iterations a call: ``f2d_jacobi_iteration.n<N>``);
  :func:`entry_launches` gives the totals by C entry point;
- ``d2h_bytes``: bytes the front end copied from the card to the host
  (:func:`to_host`): X·Y·3 for ``to_image`` of a CUDA frame, the uint8
  image, not the float32 frame;
- the graph path of the run loop (``models/replay.py``):
  ``graph_replays[<key>]``, one a replay of a step's graph, by graph
  (``<scheme>.01`` one step from layout L0, ``<scheme>.10`` one from L1,
  ``<scheme>.pair`` two from L0);
  ``graph_captures``, one a graph captured; ``graph_state_copies``, one a
  state copied into the workspace because its leaves were in no layout;
  ``eager_cuda_steps``, one a step of a CUDA state run through the
  wrappers from Python: the eager loop, or the warm-up step before a
  capture.
"""

from __future__ import annotations

import collections
import contextlib
from collections.abc import Mapping

import torch

__all__ = ["span", "enabled", "launches", "entry_launches", "add_launches", "to_host",
           "graph_replays"]

_on = False
_OFF = contextlib.nullcontext()

launches: collections.Counter[str] = collections.Counter()
d2h_bytes = 0
graph_replays: collections.Counter[str] = collections.Counter()
graph_captures = 0
graph_state_copies = 0
eager_cuda_steps = 0


def span(name: str):
    """A span named `name` for a ``with``: ``record_function(name)`` while
    spans are on, else a shared null context."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(name)


class enabled:
    """Turn spans on or off. ``enabled(True)`` sets the flag at once; in a
    ``with`` the flag it found comes back on exit, also after an
    exception."""

    def __init__(self, on: bool = True):
        global _on
        self._was, _on = _on, bool(on)

    def __enter__(self) -> "enabled":
        return self

    def __exit__(self, *exc) -> None:
        global _on
        _on = self._was


def entry_launches() -> collections.Counter[str]:
    """``launches`` by C entry point: a form counted apart
    (``<entry>.<form>``) adds to its entry point's count."""
    out: collections.Counter[str] = collections.Counter()
    for key, n in launches.items():
        out[key.partition(".")[0]] += n
    return out


def add_launches(counts: Mapping[str, int], times: int = 1) -> None:
    """Add `counts` (launches by entry point) `times` times to ``launches``.

    For a graph-replay path: a replay enqueues its captured body's kernels
    without a call to ``launch``, so the path adds the body's launches once
    per replay, and the counter keeps counting work enqueued on the device,
    not Python calls. The capture calls ``launch`` but enqueues nothing, so
    the path takes the launches counted while capturing as the body's
    counts and takes them back out (``times=-1``)."""
    for entry, n in counts.items():
        launches[entry] += n * times


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host. A CUDA tensor is copied, its bytes added to
    ``d2h_bytes``; a CPU tensor is returned as it is."""
    global d2h_bytes
    if t.device.type == "cuda":
        d2h_bytes += t.numel() * t.element_size()
    return t.detach().cpu()
