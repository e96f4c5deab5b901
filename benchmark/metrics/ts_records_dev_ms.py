"""``ts_records_dev_ms``: device time of the ops the port launched under
its ``sample_sort.records`` span (the gather of the record bytes into key
order), in the traced job, in ms."""

from benchmark.metrics._spans import device_ms


def read(record):
    return device_ms(record, "sample_sort.records")
