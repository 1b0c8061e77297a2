"""Metric arithmetic, kept apart so the tests can hold it to hand counts."""

from __future__ import annotations

import math

import numpy as np


def window_rate(done, window_s: float) -> float:
    """Ops of the steps of the window, over the window's whole length."""
    return sum(n for _t, n in done) / window_s


def nearest_rank(values, q: float) -> float:
    """The exact q-quantile (0 < q <= 1) of all values: the smallest value
    with at least a share q of the values at or below it."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if not len(v):
        raise ValueError("no values")
    return float(v[max(0, math.ceil(q * len(v)) - 1)])


def merge_intervals(iv):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(iv, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi]


def busy_and_gaps(intervals, lo: float, hi: float):
    """Seconds of [lo, hi) that the intervals cover, and the gaps between
    them as (start, end)."""
    merged = merge_intervals(clip(intervals, lo, hi))
    busy = sum(e - s for s, e in merged)
    gaps, t = [], lo
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return busy, gaps
