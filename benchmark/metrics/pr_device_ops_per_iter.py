"""``pr_device_ops_per_iter``: device ops the profiler recorded in the
traced job (its grouping, iterations and the ranks' copy to the host)
over the ``pagerank.iterations`` the port counted in it."""


def read(record):
    t = record.get("trace")
    if t is None or not t.get("iterations"):
        return None
    return t["device_ops"] / t["iterations"]
