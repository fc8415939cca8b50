"""Reduction of a traced window to the device's busy time, its idle gaps and
its operations by name.

The input is a flat list of events ``(kind, name, start_s, end_s)`` on one
clock: ``"device"`` for an operation that ran on the card (a kernel, a
copy, a fill), ``"span"`` for a span the benchmark opened on the host
around a call into the program (``step_call``, ``sync``, ``render``,
``to_image``), and ``"host"`` for any other host operation. :func:`events_from_profiler` makes that list from a
``torch.profiler`` run; the tests make it by hand.
"""

from __future__ import annotations

import bisect

__all__ = ["SPANS", "events_from_profiler", "reduce_events", "table"]

SPANS = ("step_call", "sync", "render", "to_image")


def events_from_profiler(prof, spans=SPANS) -> list[tuple[str, str, float, float]]:
    """The device operations, the benchmark's spans and the host's other
    operations (kind ``"host"``) of a finished ``torch.profiler.profile``,
    read from its raw events. A span's shadow on the device (its GPU user
    annotation) is not a device operation."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        name, on_cpu = e.name(), e.device_type() == DeviceType.CPU
        if name in spans:
            if on_cpu:
                out.append(("span", name, start, end))
        elif on_cpu:
            out.append(("host", name, start, end))
        else:
            out.append(("device", short_name(name), start, end))
    return out


def table(events, rows: int = 40) -> str:
    """Seconds and counts by name, device operations then host ones."""
    lines = []
    for kind in ("device", "host"):
        tot: dict[str, list] = {}
        for k, n, s, e in events:
            if k == kind:
                t = tot.setdefault(n, [0.0, 0])
                t[0] += e - s
                t[1] += 1
        lines.append(f"{kind} operations: seconds, count, name")
        for n, (sec, cnt) in sorted(tot.items(), key=lambda x: -x[1][0])[:rows]:
            lines.append(f"{sec:12.6f} {cnt:8d}  {n}")
        lines.append("")
    return "\n".join(lines)


def short_name(name: str) -> str:
    """A kernel's name without its argument list and leading ``void``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.removeprefix("void ").strip()


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_events(events, top: int = 10) -> dict:
    """Busy and idle time of the device over the traced window, which runs
    from the first span's start to the last span's end.

    Returns ``window_s``; ``busy_s`` (the union of the device operations);
    ``device_op_s`` (their summed durations); ``device_ops`` (the `top`
    names by summed time, ``[name, seconds]``); ``idle_by_span`` (idle
    seconds by the span the host was in, the span with the largest overlap
    naming a gap, ``none`` where the host was in none) and ``gaps`` (the
    `top` longest gaps, ``[span, seconds]``). Device time outside the
    window is cut off."""
    spans = sorted((s, e, n) for k, n, s, e in events if k == "span")
    if not spans:
        msg = "no benchmark span in the trace"
        raise ValueError(msg)
    w0, w1 = spans[0][0], max(e for _, e, _ in spans)
    by_name: dict[str, float] = {}
    clipped = []
    for k, n, s, e in events:
        if k != "device":
            continue
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e))
            by_name[n] = by_name.get(n, 0.0) + (e - s)
    busy = _union(clipped)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if w1 > t:
        gaps.append((t, w1))
    starts = [s for s, _, _ in spans]
    idle: dict[str, float] = {}
    named = []
    for a, b in gaps:
        overlap: dict[str, float] = {}
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(spans) and spans[i][0] < b:
            s, e, n = spans[i]
            o = min(b, e) - max(a, s)
            if o > 0:
                overlap[n] = overlap.get(n, 0.0) + o
            i += 1
        label = max(overlap, key=overlap.get) if overlap else "none"
        idle[label] = idle.get(label, 0.0) + (b - a)
        named.append((label, b - a))
    return {
        "window_s": w1 - w0,
        "busy_s": sum(b - a for a, b in busy),
        "device_op_s": sum(by_name.values()),
        "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        "idle_by_span": [[n, s] for n, s in sorted(idle.items(), key=lambda x: -x[1])],
        "gaps": [[n, s] for n, s in sorted(named, key=lambda x: -x[1])[:top]],
    }
