"""``ingest_ms``: the median job's ``load_rows`` (the native reader), from
the benchmark's span around the call."""

from benchmark.metrics._jobs import median_of


def read(record):
    return median_of(record, "load_ms")
