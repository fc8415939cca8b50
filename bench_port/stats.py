"""Statistics of a run's timings: a percentile over every sample, and rates
over a whole window."""

from __future__ import annotations

import math

__all__ = ["percentile", "rate", "mean"]


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, interpolated linearly between the
    two nearest ranks (numpy's default method). Raises on no values."""
    xs = sorted(values)
    if not xs:
        msg = "percentile of no values"
        raise ValueError(msg)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work done over the whole window's time."""
    if seconds <= 0:
        msg = f"a window of {seconds} s"
        raise ValueError(msg)
    return count / seconds


def mean(values) -> float:
    xs = list(values)
    if not xs:
        msg = "mean of no values"
        raise ValueError(msg)
    return sum(xs) / len(xs)
