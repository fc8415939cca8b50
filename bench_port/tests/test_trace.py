"""The idle share and the gap labels from a synthetic event list."""

from __future__ import annotations

import pytest

from bench_port import registry
from bench_port.trace import reduce_events, table

EVENTS = [
    ("span", "step_call", 0.0, 1.0),
    ("device", "kA", 0.1, 0.6),
    ("device", "kB", 0.5, 0.95),  # overlaps kA: busy is their union
    ("span", "render", 1.0, 1.2),
    ("device", "kA", 1.1, 1.15),
    ("span", "to_image", 1.2, 2.0),
    ("device", "Memcpy DtoH", 1.2, 1.3),
    ("host", "aten::empty", 1.25, 1.26),
    ("device", "late", 2.5, 3.0),  # after the window: cut off
]


def test_busy_idle_and_labels():
    r = reduce_events(EVENTS)
    assert r["window_s"] == pytest.approx(2.0)
    assert r["busy_s"] == pytest.approx(0.85 + 0.05 + 0.1)
    assert r["device_op_s"] == pytest.approx(0.5 + 0.45 + 0.05 + 0.1)
    idle = dict(r["idle_by_span"])
    assert idle["to_image"] == pytest.approx(0.7)
    assert idle["step_call"] == pytest.approx(0.1)  # before kA
    # 0.95..1.1 lies 0.05 in step_call and 0.1 in render; then 1.15..1.2
    assert idle["render"] == pytest.approx(0.15 + 0.05)
    assert r["gaps"][0] == ["to_image", pytest.approx(0.7)]
    assert r["device_ops"][0] == ["kA", pytest.approx(0.55)]
    assert "late" not in dict(r["device_ops"])


def test_a_gap_spanning_two_spans_takes_the_larger_overlap():
    ev = [("span", "render", 0.0, 0.3), ("span", "to_image", 0.3, 1.0),
          ("device", "k", 0.0, 0.1)]
    r = reduce_events(ev)
    assert r["gaps"] == [["to_image", pytest.approx(0.9)]]


def test_idle_share_for_every_name_of_the_quantity():
    rec = {"loop": "frames", "trace": reduce_events(EVENTS)}
    for name in ("device_idle_pct.view", "device_idle_pct.run", "device_idle_pct.host_bound"):
        assert registry.reader(name)(rec) == pytest.approx(100 * (1 - 1.0 / 2.0))
    assert registry.reader("device_idle_pct.view")({"loop": "frames"}) is None


def test_no_span_raises_and_the_table_lists_both_kinds():
    with pytest.raises(ValueError):
        reduce_events([("device", "k", 0.0, 1.0)])
    t = table(EVENTS)
    assert "kA" in t and "aten::empty" in t
