"""``gather_add_roofline``: PageRank's gather-add kernel's
(``csrc/pagerank.cu``) share of its bandwidth bound.  The least bytes of
one weighted call over the graph's nodes and arcs with 4-byte indices
(frozen formula) over the peak, against the kernel's device time in the
traced job over its launches there (the port's counter).  The bytes
bound only: the chain of a row's ordered adds is a property of the
kernel's design, not of the work."""

from benchmark.frozen import profile, roofline


def read(record):
    t = record.get("trace")
    n = (t or {}).get("launches", {}).get("gather_add")
    g = record.get("graph")
    if not n or not g:
        return None
    least = roofline.pagerank_gather_min_bytes(g["nodes"], g["arcs"], index_bytes=4)
    return roofline.roofline_pct(least, profile.kernel_seconds(t, "gather_add_kernel") / n,
                                 record.get("device_name"))
