"""What the readers share: the median over the window's jobs of a number
each job's record holds."""

from __future__ import annotations

import statistics


def median_of(record: dict, key: str):
    """The median of ``key`` over the jobs that have it; None if none."""
    vals = [j[key] for j in record.get("jobs", []) if j.get(key) is not None]
    return float(statistics.median(vals)) if vals else None

