"""``device_ops_per_block.stream``: ``device_ops_per_block`` in the stream cell."""

from benchmark.metrics.device_ops_per_block import read  # noqa: F401
