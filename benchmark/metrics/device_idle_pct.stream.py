"""``device_idle_pct.stream``: ``device_idle_pct`` in the stream cell."""

from benchmark.metrics.device_idle_pct import read  # noqa: F401
