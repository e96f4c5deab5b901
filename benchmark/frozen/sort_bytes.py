"""The least bytes of a TeraSort job: every record read once and written
once, ``2 x record_bytes x records``.

No sort of records held in device memory can move fewer: each input
record is read and each output record written at least once, whatever
else the sort does.  A job's wall time over this many bytes at the
card's peak (``frozen/roofline.py``) can therefore never read above
100%.
"""

from __future__ import annotations


def terasort_min_bytes(records: int, record_bytes: int) -> int:
    """The records in, the sorted records out."""
    return 2 * record_bytes * records
