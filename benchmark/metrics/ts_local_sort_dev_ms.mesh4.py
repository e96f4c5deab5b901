"""``ts_local_sort_dev_ms.mesh4``: ``ts_local_sort_dev_ms`` (the ops under
``sample_sort.local``) on rank 0 of the four-card cell."""

from benchmark.metrics.ts_local_sort_dev_ms import read  # noqa: F401
