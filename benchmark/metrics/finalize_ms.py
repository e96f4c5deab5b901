"""``finalize_ms``: the median job's host decode of the device table
(``to_host_pairs``: ``engine.finalize_host_pairs``), from the
benchmark's span around it."""

from benchmark.metrics._jobs import median_of


def read(record):
    return median_of(record, "finalize_ms")
