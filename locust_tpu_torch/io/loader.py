"""Corpus ingest: text file -> NUL-padded uint8 line rows.

Port of ``locust_tpu/io/loader.py``: the ``[line_start, line_end)``
node-shard slice, the lossless capacity sizing behind ``--auto-caps``,
the prefetching reader thread and ``StreamingCorpus``, the bounded-memory
block reader behind ``--stream``.  ``load_rows``, ``StreamingCorpus`` and
``measure_caps_stream`` read through the native reader
(``io/native_ingest.py``, ``csrc/ingest.cpp``) by default; the pure-Python
paths, whose output it equals byte for byte, run only when the caller
passes ``use_native=False``.  Unlike the JAX package, a native reader that
fails to build raises ``OSError``: there is no silent fallback.
"""

from __future__ import annotations

import hashlib
import os
import queue
import re
import threading

import numpy as np

from locust_tpu_torch.config import FULL_DELIMITERS
from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.io import native_ingest

# The engine's token boundaries: the strtok set plus NUL and CR/LF.
_TOKEN_SPLIT = re.compile(b"[" + re.escape(FULL_DELIMITERS) + b"]+")


def load_lines(path: str, line_start: int = -1, line_end: int = -1) -> list[bytes]:
    """Read lines, applying the reference's [start, end) node-shard slice.

    ``-1`` for both means the whole file; out-of-range ends clamp.
    Records split on ``\\n`` only and exactly one trailing ``\\r`` is
    stripped (CRLF); a lone ``\\r`` is data.
    """
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()  # trailing newline, not an empty final record
    lines = [ln[:-1] if ln.endswith(b"\r") else ln for ln in lines]
    if line_start < 0 and line_end < 0:
        return lines
    start = max(line_start, 0)
    end = len(lines) if line_end < 0 else min(line_end, len(lines))
    return lines[start:end]


def load_rows(path: str, line_width: int, line_start: int = -1,
              line_end: int = -1, use_native: bool = True) -> np.ndarray:
    """File -> padded ``[lines, line_width]`` uint8 rows, through the
    native reader unless ``use_native=False``."""
    if use_native:
        return native_ingest.load_rows(path, line_width, line_start, line_end)
    return bytes_ops.strings_to_rows(
        load_lines(path, line_start, line_end), line_width
    )


def measure_caps(lines) -> tuple[int, int]:
    """One host pass: (max token bytes, max tokens per line) over
    ``lines``, split on the engine's full delimiter set, each distinct
    line measured once.  Caps set to these maxima drop or cut nothing
    that larger caps keep."""
    max_tok, max_per_line = 1, 1
    for ln in set(lines):
        toks = [t for t in _TOKEN_SPLIT.split(ln) if t]
        if toks:
            max_per_line = max(max_per_line, len(toks))
            max_tok = max(max_tok, max(len(t) for t in toks))
    return max_tok, max_per_line


def size_caps(max_tok: int, max_per_line: int, key_cap: int, emits_cap: int) -> tuple[int, int]:
    """The one lossless sizing rule: measured maxima, lane-rounded key
    width (floor 8), never above the caller's caps."""
    kw = min(key_cap, max(8, -(-max_tok // 4) * 4))
    epl = min(emits_cap, max_per_line)
    return kw, epl


def count_distinct_tokens(lines) -> int:
    """Exact distinct-token count under the engine's tokenization, each
    distinct line counted once: an upper bound of the engine's distinct
    keys when the key width is at least the longest token."""
    toks: set[bytes] = set()
    for ln in set(lines):
        toks.update(t for t in _TOKEN_SPLIT.split(ln) if t)
    return len(toks)


def auto_caps(lines, key_cap: int, emits_cap: int) -> tuple[int, int, int, int]:
    """Lossless capacity sizing: ``(key_width, emits_per_line, max_tok,
    max_per_line)`` with the caps at their measured floors, never above
    ``key_cap`` / ``emits_cap``."""
    max_tok, max_per_line = measure_caps(lines)
    kw, epl = size_caps(max_tok, max_per_line, key_cap, emits_cap)
    return kw, epl, max_tok, max_per_line


def measure_caps_rows(row_blocks) -> tuple[int, int]:
    """Bounded-memory (max token bytes, max tokens per line) over an
    iterable of padded ``[n, width]`` uint8 row blocks, tokenized as the
    device does (NUL padding contributes nothing); numpy per block."""
    lut = np.zeros(256, dtype=bool)
    lut[np.frombuffer(FULL_DELIMITERS, np.uint8)] = True
    max_tok, max_per_line = 1, 1
    for blk in row_blocks:
        rows = np.asarray(blk, dtype=np.uint8)
        if rows.size == 0:
            continue
        is_delim = lut[rows]
        starts = ~is_delim
        starts[:, 1:] &= is_delim[:, :-1]
        max_per_line = max(max_per_line, int(starts.sum(axis=1).max()))
        run = np.zeros(rows.shape[0], dtype=np.int32)
        longest = np.zeros(rows.shape[0], dtype=np.int32)
        for c in range(rows.shape[1]):
            run = np.where(is_delim[:, c], 0, run + 1)
            np.maximum(longest, run, out=longest)
        max_tok = max(max_tok, int(longest.max()))
    return max_tok, max_per_line


def measure_caps_stream(stream: "StreamingCorpus") -> tuple[int, int]:
    """Caps of a ``StreamingCorpus``'s width-truncated ``[line_start,
    line_end)`` view: the native single-pass scan, or, when the stream
    has ``use_native=False``, ``measure_caps_rows`` over its blocks."""
    if stream.use_native:
        return native_ingest.measure_caps(stream.path, stream.line_width,
                                          stream.line_start, stream.line_end)
    return measure_caps_rows(stream)


class _PrefetchError:
    """An exception crossing the reader thread (a private type no block
    iterator yields)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_blocks(blocks, depth: int = 2):
    """Iterate ``blocks`` with a daemon reader thread ``depth`` items
    ahead: the same items in the same order, the source's exceptions
    raised at the consuming ``next()``.

    Abandoning the generator (``close()``, or the consumer raising) stops
    the reader: its puts poll a stop event, and the generator's
    ``finally`` sets it and drains the queue, so no thread or staged block
    outlives the consumer."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    end = object()
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            for b in blocks:
                if not put_or_stop(b):
                    return
            put_or_stop(end)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            put_or_stop(_PrefetchError(e))

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _PrefetchError):
                raise item.exc
            yield item
    finally:
        stop.set()
        # Drain until the reader has exited (a put may have passed the
        # stop check); bounded, since a reader stuck inside next(blocks)
        # never sees the stop.
        for _ in range(5):
            _drain(q)
            if not t.is_alive():
                break
            t.join(timeout=0.2)
        _drain(q)


def _drain(q: queue.Queue) -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def count_lines(path: str) -> int:
    """Streaming line count; a final line without a newline counts."""
    n = 0
    last = b"\n"
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            n += chunk.count(b"\n")
            last = chunk[-1:]
    if last != b"\n":
        n += 1
    return n


class StreamingCorpus:
    """``[<=block_lines, line_width]`` uint8 row blocks of a file in bounded
    memory: one ``chunk_bytes`` window plus one carried partial line at a
    time, honouring the ``[line_start, line_end)`` slice.  Every block but
    the last has ``block_lines`` rows.  A line longer than the window is
    cut to ``line_width`` (the device contract anyway).  ``fingerprint()``
    is the file's identity for checkpoint resume, without a full read.
    Blocks come from the native windowed scanner (a 1 MB buffer) unless
    ``use_native=False``, which takes the Python chunked reader."""

    def __init__(self, path: str, line_width: int, block_lines: int,
                 line_start: int = -1, line_end: int = -1, chunk_bytes: int = 32 << 20,
                 use_native: bool = True):
        if block_lines < 1 or line_width < 1:
            raise ValueError("block_lines and line_width must be >= 1")
        self.path = path
        self.line_width = line_width
        self.block_lines = block_lines
        self.line_start = line_start
        self.line_end = line_end
        self.chunk_bytes = max(chunk_bytes, 1 << 16)
        self.use_native = use_native

    def fingerprint(self) -> str:
        """Path + size + mtime + a digest of the first MiB + the slice,
        exactly as the JAX package spells it."""
        st = os.stat(self.path)
        h = hashlib.sha256()
        with open(self.path, "rb") as f:
            h.update(f.read(1 << 20))
        return (
            f"{os.path.abspath(self.path)}:{st.st_size}:{st.st_mtime_ns}:"
            f"{h.hexdigest()[:16]}:{self.line_start}:{self.line_end}"
        )

    def __iter__(self):
        if self.use_native:
            # An error after a block was yielded propagates: reading the
            # file again from the top would fold every block twice.
            yield from native_ingest.iter_blocks(self.path, self.line_width, self.block_lines,
                                                 self.line_start, self.line_end)
            return
        yield from self._iter_python()

    def _iter_python(self):
        start = max(self.line_start, 0)
        end = self.line_end if self.line_end >= 0 else None
        line_no = 0
        pending: list[bytes] = []
        carry = b""
        with open(self.path, "rb") as f:
            while True:
                chunk = f.read(self.chunk_bytes)
                if not chunk:
                    break
                lines = (carry + chunk).split(b"\n")
                carry = lines.pop()  # partial (or empty) trailing piece
                if len(carry) > self.line_width:
                    carry = carry[: self.line_width]
                for ln in lines:
                    if end is not None and line_no >= end:
                        break
                    if line_no >= start:
                        pending.append(ln[:-1] if ln.endswith(b"\r") else ln)
                    line_no += 1
                    if len(pending) >= self.block_lines:
                        yield bytes_ops.strings_to_rows(
                            pending[: self.block_lines], self.line_width
                        )
                        pending = pending[self.block_lines :]
                if end is not None and line_no >= end:
                    carry = b""
                    break
        if carry and (end is None or line_no < end) and line_no >= start:
            pending.append(carry[:-1] if carry.endswith(b"\r") else carry)
        while pending:
            yield bytes_ops.strings_to_rows(pending[: self.block_lines], self.line_width)
            pending = pending[self.block_lines :]
