"""``pr_iter_host_us``: the median ``pagerank.iteration`` span over every
iteration of the window, the port's own: the host's dispatch of one
``pagerank_step`` (the dangling mass's sum, the gather-add, the damping),
which does not wait for the card, in us."""

import statistics


def read(record):
    vals = [u for j in record.get("jobs", []) for u in j.get("iteration_us") or []]
    return float(statistics.median(vals)) if vals else None
