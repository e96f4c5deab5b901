"""``device_idle_pct.terasort_mesh4``: ``device_idle_pct`` of rank 0's card
in the four-card TeraSort cell."""

from benchmark.metrics.device_idle_pct import read  # noqa: F401
