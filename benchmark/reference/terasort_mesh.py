"""TeraSort's global order over the ranks of a mesh, in plain ``torch``, and
each rank's share of it.

The input is every rank's records in rank order: rank ``r``'s ``i``-th
record is global row ``offset[r] + i``.  The global order is the stable
ascending order of those rows by their first ``key_bytes`` bytes, read as
unsigned base-256 digits of at most seven bytes (``reference/terasort.py``'s
``key_digits``), one stable sort a digit, least significant first, over the
keys alone: the int64 digits and a global row index, no record bytes.
Records of equal keys keep their global row order, so ties are
sender-major.  Each rank's records are made by ``make(r)`` (the run
regenerates them from their seeds) one rank at a time, once for the keys
and once for a rank's share, so the device holds one rank's records at a
time beside the order.

The ranks' outputs in rank order are right when rank ``d``'s ``m_d``
records equal, position by position, the records at global positions
``[m_0 + .. + m_{d-1}, .. + m_d)`` of that order: ``share``.  Nothing of
the port or of JAX is imported.
"""

from __future__ import annotations

import torch

from benchmark.reference import terasort as one


def offsets(sizes: list[int]) -> list[int]:
    """Each rank's first global row, and the total last."""
    out = [0]
    for n in sizes:
        out.append(out[-1] + int(n))
    return out


def global_order(make, ranks: int, key_bytes: int) -> tuple[torch.Tensor, list[int]]:
    """The stable ascending order of every rank's records by key, as global
    rows (int64, on the records' device), and each rank's record count."""
    digits, sizes = [], []
    for r in range(ranks):
        recs = make(r)
        sizes.append(int(recs.shape[0]))
        digits.append(one.key_digits(recs, key_bytes))
        del recs
    keys = [torch.cat([d[i] for d in digits]) for i in range(len(digits[0]))]
    del digits
    idx = torch.arange(keys[0].shape[0], device=keys[0].device)
    for d in reversed(keys):
        idx = idx[torch.sort(d[idx], stable=True).indices]
    return idx, sizes


def share(order: torch.Tensor, lo: int, count: int, sizes: list[int], make) -> torch.Tensor:
    """The records at global positions ``[lo, lo + count)`` of ``order``
    (fewer where the order ends first), gathered from each rank's records."""
    rows = order[lo:lo + count]
    first = offsets(sizes)
    out = None
    for r in range(len(sizes)):
        mine = (rows >= first[r]) & (rows < first[r + 1])
        if not bool(mine.any()):
            continue
        recs = make(r)
        if out is None:
            out = torch.empty((rows.shape[0], recs.shape[1]), dtype=recs.dtype,
                              device=recs.device)
        out[mine] = recs[rows[mine] - first[r]]
        del recs
    return out if out is not None else torch.empty((0, 0), dtype=torch.uint8,
                                                   device=order.device)


def boundary_pairs(edges: list, key_bytes: int) -> int:
    """valsort's order check across rank boundaries: ``edges`` holds each
    rank's first and last record (``None`` for a rank that holds none), in
    rank order; counts the ranks whose first key is below the last key of
    the nearest rank before them that holds records."""
    bad, last = 0, None
    for edge in edges:
        if edge is None:
            continue
        first, end = edge
        if last is not None:
            bad += one.unordered_pairs(torch.stack([last, first]), key_bytes)
        last = end
    return bad
