"""``ts_host_syncs_per_job``: the median job's rise of the port's
``sample_sort.host_syncs`` counter (host reads of the sample sort's
tensors)."""

from benchmark.metrics._jobs import median_of


def read(record):
    return median_of(record, "host_syncs")
