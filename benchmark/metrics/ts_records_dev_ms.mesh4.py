"""``ts_records_dev_ms.mesh4``: ``ts_records_dev_ms`` (the ops under
``sample_sort.records``) on rank 0 of the four-card cell."""

from benchmark.metrics.ts_records_dev_ms import read  # noqa: F401
