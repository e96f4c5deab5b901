"""The benchmark's arithmetic on records: rates, medians, spreads, idle shares."""

from __future__ import annotations

import statistics


def rate(total: float, seconds: float) -> float:
    """Work over time; the time is all of the window's."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return total / seconds


def median(values) -> float:
    return float(statistics.median(values))


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median, the quartiles as ``statistics.quantiles(values, n=4)`` gives
    them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def idle_pct(busy_s: float, window_s: float) -> float:
    """Share of a window in which the device ran nothing, in percent."""
    if window_s <= 0:
        raise ValueError(f"a window of {window_s} s has no idle share")
    return 100.0 * (1.0 - busy_s / window_s)


def merge_intervals(intervals) -> list[tuple[float, float]]:
    """Union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
