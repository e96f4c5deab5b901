"""``device_ops_per_block``: device ops the profiler recorded in the
traced window over the blocks folded in it."""


def read(record):
    t = record.get("trace")
    if t is None or not t.get("blocks"):
        return None
    return t["device_ops"] / t["blocks"]
