"""Reduction of a traced window by the program's own spans (``f2d.*``,
``fluid2d_tpu_torch/utils/trace.py``).

The input is the event list of :func:`bench_port.trace.events_from_profiler`:
the program's spans arrive there as ``"host"`` events named ``f2d.*``, their
shadows on the device (the profiler's GPU user annotations) as ``"device"``
events of the same names, which are not device operations and are dropped,
and the benchmark's own spans as ``"span"`` events. Spans nest on the host
thread, so a span's parent is the span open around it.
"""

from __future__ import annotations

from bench_port.trace import _union

__all__ = ["reduce_program", "table", "per_unit"]

PREFIX = "f2d."


def _segments(spans, w0: float, w1: float):
    """The window cut where the host's open spans change:
    ``(start, end, benchmark span, innermost program span)``, each ``none``
    where no such span is open. `spans` are ``(start, end, name)`` sorted by
    start, the longer first."""
    out, stack, t = [], [], w0

    def emit(upto):
        nonlocal t
        if upto > t:
            inner = next((n for _, _, n in reversed(stack) if n.startswith(PREFIX)), "none")
            outer = next((n for _, _, n in stack if not n.startswith(PREFIX)), "none")
            out.append((t, upto, outer, inner))
            t = upto

    for s, e, n in spans:
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            stack.pop()
        emit(s)
        stack.append((s, e, n))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    emit(w1)
    return out


def _self_times(spans):
    """Each program span's duration less the part its child program spans
    cover: ``{name: [count, total_s, self_s]}``."""
    out: dict[str, list] = {}
    stack: list[list] = []  # [end, name, duration, children's duration]

    def close(item):
        end, name, dur, kids = item
        row = out.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += dur
        row[2] += dur - kids

    for s, e, n in spans:
        while stack and stack[-1][0] <= s:
            close(stack.pop())
        if stack:
            stack[-1][3] += e - s
        stack.append([e, n, e - s, 0.0])
    while stack:
        close(stack.pop())
    return out


def reduce_program(events) -> dict:
    """The program's spans and the device's idle time by span, over the
    window from the first span's start (the benchmark's or the program's)
    to the last one's end.

    Returns ``window_s``, ``busy_s`` (the union of the device operations
    inside the window); ``spans``: for each program span name its
    ``count``, summed ``total_s`` and ``self_s`` (the duration less the part
    its child program spans cover); ``idle_by_span``: idle seconds of the
    device by the innermost program span the host was in (``none`` where it
    was in none); ``idle_under``: the same for each benchmark span the host
    was in (``none`` outside them)."""
    spans = sorted(((s, e, n) for k, n, s, e in events
                    if (k == "host" and n.startswith(PREFIX)) or k == "span"),
                   key=lambda x: (x[0], -x[1]))
    if not spans:
        msg = "no span in the trace"
        raise ValueError(msg)
    w0, w1 = spans[0][0], max(e for _, e, _ in spans)
    busy = _union((max(s, w0), min(e, w1)) for k, n, s, e in events
                  if k == "device" and not n.startswith(PREFIX) and min(e, w1) > max(s, w0))
    idle_by: dict[str, float] = {}
    under: dict[str, dict[str, float]] = {}
    b = 0
    for a, z, outer, inner in _segments(spans, w0, w1):
        # the part of [a, z) that no device operation covers
        idle, t = 0.0, a
        while b < len(busy) and busy[b][1] <= a:
            b += 1
        i = b
        while i < len(busy) and busy[i][0] < z:
            if busy[i][0] > t:
                idle += busy[i][0] - t
            t = max(t, busy[i][1])
            i += 1
        if z > t:
            idle += z - t
        if idle > 0:
            idle_by[inner] = idle_by.get(inner, 0.0) + idle
            row = under.setdefault(outer, {})
            row[inner] = row.get(inner, 0.0) + idle
    timed = _self_times([x for x in spans if x[2].startswith(PREFIX)])
    return {
        "window_s": w1 - w0,
        "busy_s": sum(z - a for a, z in busy),
        "spans": {n: {"count": c, "total_s": tot, "self_s": slf}
                  for n, (c, tot, slf) in sorted(timed.items())},
        "idle_by_span": idle_by,
        "idle_under": under,
    }


def per_unit(record: dict, match, key: str, per: str):
    """The probe's summed `key` (``total_s`` or ``self_s``) over the program
    spans whose names `match` accepts, over its count `per` (``steps`` or
    ``calls``); None where the record holds no probe or no such span."""
    rec = record.get("program_spans")
    if not rec or not rec.get(per):
        return None
    rows = [row[key] for name, row in rec["spans"].items() if match(name)]
    return sum(rows) / rec[per] if rows else None


def table(red: dict) -> str:
    """The reduction and the probe's counters as text."""
    lines = [f"window {red['window_s']:.6f} s, device busy {red['busy_s']:.6f} s; "
             f"{red.get('calls')} calls, {red.get('steps')} steps",
             "program spans: count, total seconds, self seconds, name"]
    for n, row in sorted(red["spans"].items(), key=lambda x: -x[1]["total_s"]):
        lines.append(f"{row['count']:8d} {row['total_s']:12.6f} {row['self_s']:12.6f}  {n}")
    lines.append("device idle seconds by innermost program span:")
    for n, s in sorted(red["idle_by_span"].items(), key=lambda x: -x[1]):
        lines.append(f"{s:12.6f}  {n}")
    lines.append("device idle seconds by benchmark span, then innermost program span:")
    for outer, row in sorted(red["idle_under"].items()):
        for n, s in sorted(row.items(), key=lambda x: -x[1]):
            lines.append(f"{s:12.6f}  {outer} / {n}")
    lines.append(f"launches by entry point: {red.get('launches')}")
    lines.append(f"device-to-host bytes: {red.get('d2h_bytes')}")
    return "\n".join(lines) + "\n"
