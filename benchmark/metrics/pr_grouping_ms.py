"""``pr_grouping_ms``: the median job's ``pagerank.grouping`` span, the
port's own (``apps/pagerank.pagerank_grouping``: ``in_edges``' counts,
node schedule and stable sort of the arcs, to its read of the warp-row
count), in ms."""

from benchmark.metrics._jobs import median_of


def read(record):
    return median_of(record, "grouping_ms")
