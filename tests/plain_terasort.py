"""Plain TeraSort: the reference the port's record sort is held against in
the tests.

Plain ``torch`` operations only, nothing of ``locust_tpu`` or
``locust_tpu_torch``: the stable ascending order of fixed-width records
by their first ``key_bytes`` bytes, compared as unsigned bytes, and the
records gathered in that order.  The key is read as base-256 digits of
at most seven bytes, each an int64 that stays non-negative, and the
records are sorted least significant digit first, one stable sort a
digit (an LSD radix sort over those digits), not by the port's 32-bit
lanes.  Records of equal keys keep their input order.  The benchmark
keeps its own frozen copy (``benchmark/reference/terasort.py``).
"""

from __future__ import annotations

import torch

# Key bytes per int64 digit: seven keep every digit non-negative.
DIGIT_BYTES = 7


def key_digits(records: torch.Tensor, key_bytes: int) -> list[torch.Tensor]:
    """The key of each ``[n, R]`` uint8 record as int64 digits of up to
    ``DIGIT_BYTES`` bytes, most significant first."""
    digits = []
    for lo in range(0, key_bytes, DIGIT_BYTES):
        d = torch.zeros(records.shape[0], dtype=torch.int64, device=records.device)
        for b in range(lo, min(lo + DIGIT_BYTES, key_bytes)):
            d = d * 256 + records[:, b].long()
        digits.append(d)
    return digits


def order(records: torch.Tensor, key_bytes: int) -> torch.Tensor:
    """The stable ascending order of the records by their key: one stable
    sort a digit, least significant first."""
    idx = torch.arange(records.shape[0], device=records.device)
    for d in reversed(key_digits(records, key_bytes)):
        idx = idx[torch.sort(d[idx], stable=True).indices]
    return idx


def terasort(records: torch.Tensor, key_bytes: int) -> torch.Tensor:
    """The ``[n, R]`` uint8 records in the stable order of their keys."""
    return records[order(records, key_bytes)]
