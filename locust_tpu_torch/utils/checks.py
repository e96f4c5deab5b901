"""Runtime invariant checks of a table (the sanitizer analog).

Port of ``validate_batch`` from ``locust_tpu/utils/checks.py``: host-side
structural checks for tests and debugging, raising ``AssertionError``
with the first offending row, on the same batches as the JAX function.
The engine sweeps every result table with it when ``LOCUST_DEBUG_CHECKS``
is set.  JAX's ``checkify_pipeline`` wraps a jitted function in XLA's
checkify transform; the port's eager torch ops raise their index errors
themselves, so it has no counterpart here.
"""

from __future__ import annotations

import numpy as np

from locust_tpu_torch.core.kv import KVBatch


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def validate_batch(batch: KVBatch, expect_sorted: bool = False,
                   expect_compact: bool = False) -> None:
    """Check a table on the host: the shapes and dtypes; with
    ``expect_compact`` that the valid rows are a prefix; with
    ``expect_sorted`` that the valid rows are in lexicographic order of
    their unsigned lanes; and that every valid key is NUL-padded (no
    nonzero byte after a NUL)."""
    lanes_t, valid_t, values_t = batch.key_lanes.cpu(), batch.valid.cpu(), batch.values.cpu()
    _check(lanes_t.ndim == 2 and str(lanes_t.dtype) == "torch.int32",
           "lanes must be [N, L] int32 (uint32 bit patterns)")
    lanes = lanes_t.numpy()
    valid = valid_t.numpy()
    values = values_t.numpy()
    _check(valid.shape == (lanes.shape[0],) and valid.dtype == bool,
           "valid must be a [N] bool mask")
    _check(values.shape == (lanes.shape[0],), "values must be [N]")

    if expect_compact and valid.any():
        last_valid = int(np.max(np.nonzero(valid)[0]))
        _check(bool(valid[: last_valid + 1].all()), "valid rows not a prefix")
    # The lanes as unsigned values: a signed compare of the int32 bit
    # patterns would misorder every lane with its top bit set.
    live = lanes[valid].astype(np.int64) & 0xFFFFFFFF
    if expect_sorted and live.shape[0] > 1:
        a, b = live[:-1], live[1:]
        # a <= b row-wise, decided at the first differing lane.
        neq = a != b
        first = np.argmax(neq, axis=1)
        r = np.arange(a.shape[0])
        bad = np.nonzero(neq.any(axis=1) & ~(a[r, first] < b[r, first]))[0]
        _check(bad.size == 0, f"rows {bad[0] if bad.size else '?'},"
                              f"{bad[0] + 1 if bad.size else '?'} out of order")
    # NUL-padded keys: once a byte is NUL every later byte is NUL.
    kb = live.astype(">u4").view(np.uint8).reshape(live.shape[0], 4 * live.shape[1])
    if kb.size:
        nonzero = kb != 0
        bad = np.nonzero(((~nonzero[:, :-1]) & nonzero[:, 1:]).any(axis=1))[0]
        _check(bad.size == 0, f"row {bad[0] if bad.size else '?'} has bytes after NUL "
                              "(interior NUL key)")
