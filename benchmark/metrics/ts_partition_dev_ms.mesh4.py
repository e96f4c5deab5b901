"""``ts_partition_dev_ms.mesh4``: ``ts_partition_dev_ms`` (the ops under
``sample_sort.sample`` and ``sample_sort.partition``) on rank 0 of the
four-card cell."""

from benchmark.metrics.ts_partition_dev_ms import read  # noqa: F401
