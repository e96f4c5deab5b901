"""``ts_host_syncs_per_job.mesh4``: ``ts_host_syncs_per_job`` (the median
job's rise of ``sample_sort.host_syncs``) on rank 0 of the four-card
cell."""

from benchmark.metrics.ts_host_syncs_per_job import read  # noqa: F401
