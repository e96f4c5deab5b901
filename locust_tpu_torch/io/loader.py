"""Corpus ingest: text file -> NUL-padded uint8 line rows.

Port of ``locust_tpu/io/loader.py:26-50`` and the pure-Python path of
``load_rows`` (the JAX package's native ingest is a later slice).
"""

from __future__ import annotations

import numpy as np

from locust_tpu_torch.core import bytes_ops


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
              line_end: int = -1) -> np.ndarray:
    """File -> padded ``[lines, line_width]`` uint8 rows."""
    return bytes_ops.strings_to_rows(
        load_lines(path, line_start, line_end), line_width
    )
