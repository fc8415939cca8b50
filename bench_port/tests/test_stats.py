"""Percentiles over every sample and rates over the whole window."""

from __future__ import annotations

import pytest

from bench_port import registry
from bench_port.stats import percentile


def test_percentile_matches_linear_ranks():
    xs = list(range(1, 101))  # 1..100
    assert percentile(xs, 95) == pytest.approx(95.05)
    assert percentile([5.0], 95) == 5.0
    assert percentile([3, 1, 2], 50) == 2


def test_frame_p95_sees_a_stall_and_the_rates_span_the_window():
    frames = [0.010] * 190 + [0.500] * 10  # a 0.5 s stall in 10 of 200 frames
    rec = {"counts": "calls", "call_s": frames, "window_s": sum(frames) + 0.002, "calls": 200}
    p95 = registry.reader("frame_ms_p95")(rec)
    assert p95 == pytest.approx(1e3 * (0.010 + (0.5 - 0.010) * 0.05), rel=1e-9)
    fps = registry.reader("frames_per_s")(rec)
    assert fps == pytest.approx(200 / 6.902)  # the stall counts: not 1/median = 100
    assert registry.reader("steps_per_s")(rec) is None


def test_steps_rate_over_the_whole_window_with_the_drain():
    rec = {"counts": "steps", "steps": 12_000, "window_s": 10.25, "call_s": []}
    assert registry.reader("steps_per_s")(rec) == pytest.approx(12_000 / 10.25)
    assert registry.reader("frames_per_s")(rec) is None
    assert registry.reader("frame_ms_p95")(rec) is None


def test_probe_means():
    assert registry.reader("view_ms.view")({"view_s": [0.01, 0.03]}) == pytest.approx(20.0)
    assert registry.reader("host_us_per_step.run")({"host_step_s": [1e-4, 3e-4]}) == \
        pytest.approx(200.0)
    assert registry.reader("view_ms.view")({}) is None
    with pytest.raises(ValueError):
        percentile([], 95)
