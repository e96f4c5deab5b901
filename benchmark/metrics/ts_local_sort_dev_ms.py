"""``ts_local_sort_dev_ms``: device time of the ops the port launched under
its ``sample_sort.local`` span (the lex ``sort_and_compact`` of what the
rank received), in the traced job, in ms."""

from benchmark.metrics._spans import device_ms


def read(record):
    return device_ms(record, "sample_sort.local")
