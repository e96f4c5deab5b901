"""``finalize_ms.stream``: ``finalize_ms`` in the stream cell."""

from benchmark.metrics.finalize_ms import read  # noqa: F401
