"""``ts_exchange_dev_ms.mesh4``: device time of the ops rank 0 launched
under the port's ``sample_sort.exchange`` span (the keys' and the records'
all-to-all: NCCL's kernels, their wait for the peers included), in the
traced job, in ms."""

from benchmark.metrics._spans import device_ms


def read(record):
    return device_ms(record, "sample_sort.exchange")
