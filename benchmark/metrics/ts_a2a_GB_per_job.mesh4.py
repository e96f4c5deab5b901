"""``ts_a2a_GB_per_job.mesh4``: the median job's rise of rank 0's
``mesh.all_to_all_bytes`` counter (the send buffers its all-to-alls handed
to the backend: the packed key bins and the binned records, empty slots
included), in GB (10^9 bytes)."""

from benchmark.metrics._jobs import median_of


def read(record):
    sent = median_of(record, "a2a_bytes")
    return None if sent is None else sent / 1e9
