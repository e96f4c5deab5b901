"""WordCount under the configuration's stated semantics, in plain Python
and numpy.

The semantics (a configuration's ``semantics`` object):

* records split on ``\\n``; a record is cut to its first ``line_width``
  bytes;
* a token is a maximal run of bytes outside ``delimiters``;
* a record emits its first ``emits_per_line`` tokens, the rest are
  dropped;
* a key is the first ``key_width`` bytes of its token;
* a key's count is the number of its emits, held in a two's-complement
  integer of ``count_bits`` bits (it wraps).

``count_line`` is that definition for one record.  ``wordcount`` applies
it to a whole text: every record that could be cut (longer than the
width, more tokens than the cap, or a token longer than the key) goes
through ``count_line``; the others, whose keys are simply their tokens,
are counted in bulk.  ``tests/test_bench_reference.py`` holds the two
against each other.
"""

from __future__ import annotations

import collections
import re

import numpy as np


def semantics_delimiters(sem: dict) -> bytes:
    return sem["delimiters"].encode("latin-1")


def _splitter(delimiters: bytes):
    return re.compile(b"[" + re.escape(delimiters) + b"]+").split


def count_line(line: bytes, sem: dict, split=None) -> list[bytes]:
    """The keys one record emits, in order."""
    split = split or _splitter(semantics_delimiters(sem))
    tokens = [t for t in split(line[: sem["line_width"]]) if t]
    return [t[: sem["key_width"]] for t in tokens[: sem["emits_per_line"]]]


def wrap(count: int, bits: int) -> int:
    """``count`` held in a two's-complement integer of ``bits`` bits."""
    count &= (1 << bits) - 1
    return count - (1 << bits) if count >> (bits - 1) else count


def wordcount(text: bytes, sem: dict, count_bits: int | None = None) -> dict[bytes, int]:
    """Every key of ``text`` and its count.  ``count_bits`` overrides the
    semantics' counter width (the control holds counts in fewer bits)."""
    bits = sem["count_bits"] if count_bits is None else count_bits
    delimiters = semantics_delimiters(sem)
    split = _splitter(delimiters)
    arr = np.frombuffer(text, np.uint8)
    n = arr.size
    if n == 0:
        return {}
    # Records: [start, end) byte ranges, the break excluded.
    breaks = np.flatnonzero(arr == ord("\n"))
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [n]])
    if starts[-1] == n:  # a final break ends the last record
        starts, ends = starts[:-1], ends[:-1]
    lut = np.zeros(256, bool)
    lut[np.frombuffer(delimiters + b"\n", np.uint8)] = True
    delim = lut[arr]
    inside = ~delim
    tok_start = inside.copy()
    tok_start[1:] &= delim[:-1]
    tok_end = inside.copy()
    tok_end[:-1] &= delim[1:]
    t0 = np.flatnonzero(tok_start)
    t1 = np.flatnonzero(tok_end) + 1
    record = np.searchsorted(starts, t0, side="right") - 1
    per_record = np.bincount(record, minlength=starts.size)
    long_key = np.zeros(starts.size, bool)
    long_key[record[t1 - t0 > sem["key_width"]]] = True
    slow = ((ends - starts) > sem["line_width"]) | (per_record > sem["emits_per_line"]) | long_key

    counts: collections.Counter = collections.Counter()
    # Records that nothing cuts: their keys are their tokens.
    fast = ~slow[record]
    sep = delimiters[:1]
    bulk = arr.copy()
    bulk[delim] = sep[0]
    for r in np.flatnonzero(slow):
        bulk[starts[r]:ends[r]] = sep[0]
    counts.update(bulk.tobytes().split(sep))
    counts.pop(b"", None)
    if int(fast.sum()) != sum(counts.values()):
        raise AssertionError("reference: bulk token count disagrees with the token scan")
    for r in np.flatnonzero(slow):
        counts.update(count_line(text[starts[r]:ends[r]], sem, split))
    return {k: wrap(v, bits) for k, v in counts.items()}


def compare(got, want: dict[bytes, int]) -> int:
    """Keys on which an answer (``(key, count)`` pairs or a dict) and the
    reference differ: a wrong count, a key missing or a key too many."""
    got = dict(got)
    return sum(got.get(k) != v for k, v in want.items()) + sum(k not in want for k in got)
