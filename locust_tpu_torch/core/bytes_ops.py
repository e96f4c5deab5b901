"""Byte-tensor string primitives on torch ``uint8`` rows.

Port of ``locust_tpu/core/bytes_ops.py``: a "string" is a NUL-padded row
of a ``[..., W]`` uint8 tensor, and the reference's device libc
(my_strtok_r and friends, reference MapReduce/src/util.cu) becomes
vectorized masks and prefix sums.  Every mask keeps the device of its
input.
"""

from __future__ import annotations

import numpy as np
import torch

from locust_tpu_torch.config import DELIMITERS, TOKEN_BOUNDARY_EXTRA


def delimiter_lut(delimiters: bytes = DELIMITERS, device=None) -> torch.Tensor:
    """bool ``[256]`` table: True for every byte that ends a token (the
    strtok set plus NUL and CR/LF)."""
    lut = np.zeros(256, dtype=bool)
    lut[np.frombuffer(delimiters + TOKEN_BOUNDARY_EXTRA, dtype=np.uint8)] = True
    return torch.from_numpy(lut).to(device)


def delimiter_mask(x: torch.Tensor, delimiters: bytes = DELIMITERS) -> torch.Tensor:
    """Boolean mask of the bytes of ``x`` (uint8) that terminate tokens."""
    return delimiter_lut(delimiters, x.device)[x.long()]


def token_starts(in_token: torch.Tensor) -> torch.Tensor:
    """Mask of token first-bytes given an in-token (non-delimiter) mask;
    position 0 counts as having a delimiter neighbour."""
    prev = torch.zeros_like(in_token)
    prev[..., 1:] = in_token[..., :-1]
    return in_token & ~prev


def token_ends(in_token: torch.Tensor) -> torch.Tensor:
    """Mask of token last-bytes (right neighbour is a delimiter or the
    row end)."""
    nxt = torch.zeros_like(in_token)
    nxt[..., :-1] = in_token[..., 1:]
    return in_token & ~nxt


def token_ids(starts: torch.Tensor) -> torch.Tensor:
    """int32 0-based token index at every byte (valid where in-token):
    ``cumsum(starts) - 1``, kept in int32 as the JAX package does."""
    return torch.cumsum(starts.to(torch.int32), dim=-1, dtype=torch.int32) - 1


def rows_to_strings(rows: np.ndarray) -> list[bytes]:
    """Host-side: NUL-padded uint8 rows -> Python bytes (up to first NUL)."""
    out = []
    for row in np.asarray(rows):
        b = row.tobytes()
        i = b.find(b"\x00")
        out.append(b if i < 0 else b[:i])
    return out


def strings_to_rows(strings: list[bytes], width: int) -> np.ndarray:
    """Host-side: byte strings -> NUL-padded uint8 rows, truncated to width."""
    out = np.zeros((len(strings), width), dtype=np.uint8)
    for i, s in enumerate(strings):
        s = s[:width]
        out[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return out
