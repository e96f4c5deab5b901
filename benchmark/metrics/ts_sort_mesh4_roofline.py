"""``ts_sort_mesh4_roofline``: ``ts_sort_roofline`` of the four-card cell.
The least bytes of the whole job, every one of the cell's records read
once and written once (frozen formula, ``frozen/sort_bytes.py``), over the
peak of all the cell's cards together (each card reads and writes its own
share), against the median job's wall time."""

from benchmark.frozen import roofline, sort_bytes
from benchmark.metrics._jobs import median_of


def read(record):
    r = record.get("records")
    cards = (record.get("config") or {}).get("chips")
    job_ms = median_of(record, "job_ms")
    if not r or not cards or not job_ms:
        return None
    least = sort_bytes.terasort_min_bytes(r["n"], r["record_bytes"])
    return roofline.roofline_pct(least / cards, job_ms / 1e3, record.get("device_name"))
