"""``ts_device_ops_per_job``: device ops (kernels, copies, sets) the
profiler recorded in the traced window over its jobs."""


def read(record):
    t = record.get("trace")
    if t is None or not t.get("jobs"):
        return None
    return t["device_ops"] / t["jobs"]
