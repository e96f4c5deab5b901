"""``stream_stall_ms``: the median job's backpressure stall in
``run_stream``, the program's own counter
(``RunResult.stream["backpressure_stall_ms"]``)."""

from benchmark.metrics._jobs import median_of


def read(record):
    return median_of(record, "stall_ms")
