"""``device_idle_pct``: the share of the traced window in which no device
op ran, averaged over the cards of the run."""

from benchmark import stats


def read(record):
    t = record.get("trace")
    return None if t is None else stats.idle_pct(t["busy_s"], t["window_s"])
