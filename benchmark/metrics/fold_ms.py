"""``fold_ms``: the median job's fold, from the benchmark's span around
the compiled plan's run to its device sync (the host decode left out)."""

from benchmark.metrics._jobs import median_of


def read(record):
    return median_of(record, "fold_ms")
