"""``ts_device_ops_per_job.mesh4``: ``ts_device_ops_per_job`` (the device
ops the profiler recorded over the traced jobs) on rank 0 of the four-card
cell."""

from benchmark.metrics.ts_device_ops_per_job import read  # noqa: F401
