"""ctypes bindings of the native reader (``csrc/ingest.cpp``).

Port of ``locust_tpu/io/native_ingest.py``.  The library builds with g++
at first use into ``build/locust_tpu_torch/`` (``_build.load``),
never at import.  A failed build raises ``OSError`` with the compiler's
output: the port has no silent fallback, and ``io/loader.py`` and
``io/serde.py`` take their Python readers only when the caller passes
``use_native=False``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from locust_tpu_torch import _build
from locust_tpu_torch.config import FULL_DELIMITERS

_lock = threading.Lock()
_lib = None

_u8p = ctypes.POINTER(ctypes.c_ubyte)
_long = ctypes.c_long
_longp = ctypes.POINTER(ctypes.c_long)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load("ingest")
            lib.ingest_count_lines.restype = _long
            lib.ingest_count_lines.argtypes = [ctypes.c_char_p]
            lib.ingest_load_rows.restype = _long
            lib.ingest_load_rows.argtypes = [ctypes.c_char_p, _u8p, _long, _long, _long, _long]
            lib.ingest_load_window.restype = _long
            lib.ingest_load_window.argtypes = [
                ctypes.c_char_p, _longp, _longp, _u8p, _long, _long, _long, _long,
            ]
            lib.ingest_measure_caps.restype = _long
            lib.ingest_measure_caps.argtypes = [
                ctypes.c_char_p, _long, _long, _long, _u8p, _long, _longp, _longp,
            ]
            lib.ingest_read_tsv.restype = _long
            lib.ingest_read_tsv.argtypes = [
                ctypes.c_char_p, _u8p, ctypes.POINTER(ctypes.c_int), _long, _long,
            ]
            _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def measure_caps(path: str, width: int, line_start: int = -1,
                 line_end: int = -1) -> tuple[int, int]:
    """One pass: (max token bytes, max tokens per line) over the
    width-truncated ``[line_start, line_end)`` slice, split on the
    engine's full delimiter set (``config.FULL_DELIMITERS``, passed in so
    it cannot drift from the device tokenizer)."""
    lib = _load()
    delims = (ctypes.c_ubyte * len(FULL_DELIMITERS)).from_buffer_copy(FULL_DELIMITERS)
    max_tok, max_per_line = ctypes.c_long(0), ctypes.c_long(0)
    rc = lib.ingest_measure_caps(
        str(path).encode(), width, line_start, line_end, delims, len(FULL_DELIMITERS),
        ctypes.byref(max_tok), ctypes.byref(max_per_line),
    )
    if rc != 0:
        raise OSError(f"native measure_caps failed on {path!r}")
    return int(max_tok.value), int(max_per_line.value)


def count_lines(path: str) -> int:
    n = _load().ingest_count_lines(str(path).encode())
    if n < 0:
        raise OSError(f"native ingest failed to read {path!r}")
    return n


def load_rows(path: str, line_width: int, line_start: int = -1,
              line_end: int = -1) -> np.ndarray:
    """File -> padded ``[rows, line_width]`` uint8, sliced ``[line_start,
    line_end)``.  The reader writes every row it returns whole, padding
    included, so the buffer starts uninitialised."""
    lib = _load()
    total = count_lines(path)
    start = max(line_start, 0)
    end = total if line_end < 0 else min(line_end, total)
    n_rows = max(end - start, 0)
    out = np.empty((n_rows, line_width), dtype=np.uint8)
    if n_rows == 0:
        return out
    wrote = lib.ingest_load_rows(str(path).encode(), _ptr(out), n_rows, line_width,
                                 line_start, line_end)
    if wrote < 0:
        raise OSError(f"native ingest failed to read {path!r}")
    return out[:wrote] if wrote < n_rows else out


def read_tsv(path: str, key_width: int) -> tuple[np.ndarray, np.ndarray]:
    """``key\\tvalue`` TSV -> (padded key rows, int32 values), in two
    passes (count, then fill) with a fixed 1 MB buffer; the semantics of
    ``io/serde.read_tsv``'s Python parser.  A value outside int32 raises
    ``OverflowError``, as the Python parser does."""
    lib = _load()

    def check(rc: int) -> int:
        if rc == -2:
            raise OverflowError(f"TSV value in {path!r} does not fit int32")
        if rc < 0:
            raise OSError(f"native TSV read failed for {path!r}")
        return rc

    n = check(lib.ingest_read_tsv(str(path).encode(), _u8p(),
                                  ctypes.POINTER(ctypes.c_int)(), 0, key_width))
    keys = np.zeros((n, key_width), dtype=np.uint8)
    values = np.zeros((n,), dtype=np.int32)
    if n:
        wrote = check(lib.ingest_read_tsv(
            str(path).encode(), _ptr(keys),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n, key_width))
        if wrote < n:  # the file shrank between the passes
            keys, values = keys[:wrote], values[:wrote]
    return keys, values


def iter_blocks(path: str, line_width: int, block_lines: int, line_start: int = -1,
                line_end: int = -1):
    """``[<=block_lines, line_width]`` row blocks from the native windowed
    scanner: one 1 MB read buffer, whatever the file's or a line's
    length."""
    lib = _load()
    offset, line_no = ctypes.c_long(0), ctypes.c_long(0)
    while True:
        out = np.zeros((block_lines, line_width), dtype=np.uint8)
        wrote = lib.ingest_load_window(
            str(path).encode(), ctypes.byref(offset), ctypes.byref(line_no), _ptr(out),
            block_lines, line_width, line_start, line_end,
        )
        if wrote < 0:
            raise OSError(f"native ingest failed to read {path!r}")
        if wrote == 0:
            return
        yield out[:wrote] if wrote < block_lines else out
