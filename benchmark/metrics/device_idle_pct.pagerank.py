"""``device_idle_pct.pagerank``: ``device_idle_pct`` in the PageRank cell."""

from benchmark.metrics.device_idle_pct import read  # noqa: F401
