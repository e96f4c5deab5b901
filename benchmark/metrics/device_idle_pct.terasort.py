"""``device_idle_pct.terasort``: ``device_idle_pct`` in the TeraSort cell."""

from benchmark.metrics.device_idle_pct import read  # noqa: F401
