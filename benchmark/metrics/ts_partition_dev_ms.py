"""``ts_partition_dev_ms``: device time of the ops the port launched under
its ``sample_sort.sample`` (the splitters) and ``sample_sort.partition``
(the buckets, ``partition_to_bins``, the keys' and the records' exchange)
spans, in the traced job, in ms."""

from benchmark.metrics._spans import device_ms


def read(record):
    return device_ms(record, "sample_sort.sample", "sample_sort.partition")
