"""``ts_sort_roofline``: a TeraSort job's share of its bandwidth bound.  The
least bytes of a job, every record read once and written once (frozen
formula, ``frozen/sort_bytes.py``), over the card's peak, against the
median job's wall time: the share of the whole job that no
implementation can change the count of."""

from benchmark.frozen import roofline, sort_bytes
from benchmark.metrics._jobs import median_of


def read(record):
    r = record.get("records")
    job_ms = median_of(record, "job_ms")
    if not r or not job_ms:
        return None
    least = sort_bytes.terasort_min_bytes(r["n"], r["record_bytes"])
    return roofline.roofline_pct(least, job_ms / 1e3, record.get("device_name"))
