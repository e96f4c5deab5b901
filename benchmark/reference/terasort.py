"""TeraSort's record order in plain ``torch``, and the comparison of an
answer with it.

Frozen copy of the repository's test reference (``tests/plain_terasort.py``),
with valsort's checks beside it; nothing of the port or of JAX.  The
stable ascending order of fixed-width records by their first
``key_bytes`` bytes, compared as unsigned bytes: the key read as base-256
digits of at most seven bytes (each a non-negative int64), the records
sorted least significant digit first, one stable sort a digit, then
gathered in that order.  Records of equal keys keep their input order.
It runs on the device of the records it is given, so on the card after
the program's state is freed.
"""

from __future__ import annotations

import torch

# Key bytes per int64 digit: seven keep every digit non-negative.
DIGIT_BYTES = 7
# Records compared per step, so a large answer's byte masks fit.
CHUNK = 1 << 24


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


def unordered_pairs(records: torch.Tensor, key_bytes: int) -> int:
    """valsort's order check: adjacent records whose first key is greater
    than the second's."""
    bad = 0
    n = records.shape[0]
    for lo in range(0, max(n - 1, 0), CHUNK):
        hi = min(lo + CHUNK, n - 1)
        a = key_digits(records[lo:hi], key_bytes)
        b = key_digits(records[lo + 1:hi + 1], key_bytes)
        gt = a[-1] > b[-1]
        for x, y in zip(reversed(a[:-1]), reversed(b[:-1])):
            gt = (x > y) | ((x == y) & gt)
        bad += int(gt.sum())
    return bad


def compare(got: torch.Tensor, want: torch.Tensor, key_bytes: int) -> dict:
    """An answer's ``[m, R]`` records against the reference's ``[n, R]``,
    on one device: ``wrong_records`` (positions whose bytes differ, a
    position held by one side only counted too), ``unordered_pairs``
    (over the answer) and ``missing_records`` (``n - m`` where the answer
    is short)."""
    m, n = got.shape[0], want.shape[0]
    k = min(m, n)
    wrong = abs(m - n)
    for lo in range(0, k, CHUNK):
        hi = min(lo + CHUNK, k)
        wrong += int((got[lo:hi] != want[lo:hi]).any(dim=1).sum())
    return {"wrong_records": wrong, "unordered_pairs": unordered_pairs(got, key_bytes),
            "missing_records": max(n - m, 0)}
