"""Process stage: compaction + key-grouping sort in one sort.

Port of ``locust_tpu/ops/process_stage.py`` for the modes of this slice:

* **"bitonic"**: the hand-written bitonic sort (ops/kernels/sort.py) over
  the folded key, with the row (key lanes + value) as payload.
* **"hashp1"**: the same single folded key, sorted by a stable
  ``torch.sort``, row gathered into place — the JAX mode's ``lax.sort``
  is stable, so this is bit-identical to it.

The hasht family (config.HASHT_FAMILY) is a fold-level strategy
(ops/hash_table.aggregate_exact); the consumers of this grouping
interface (``timed_run``'s split stages, the residual sorts of the
hasht ladder) get "hashp1" for it, as in the JAX package.

Both sort ``_folded_key``: 31 hash bits, with the invalid rows at
0xFFFFFFFF, so ascending unsigned order is "valid rows first, equal keys
adjacent".  Distinct keys that share a folded key may interleave; the
segment reduce compares full key lanes, so that only splits a key into
duplicate table rows, which the next fold or the host finalize re-merges.
The other modes raise ``NotImplementedError`` until their slice lands.
"""

from __future__ import annotations

import torch

from locust_tpu_torch.config import HASHT_FAMILY, SORT_MODES
from locust_tpu_torch.core import packing
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.ops.kernels.sort import bitonic_sort_rows

PORTED_SORT_MODES = ("bitonic", "hashp1", *HASHT_FAMILY)


def require_mode(mode: str) -> None:
    """Raise unless ``mode`` runs in this slice of the port."""
    if mode in PORTED_SORT_MODES:
        return
    if mode in SORT_MODES:
        raise NotImplementedError(
            f"sort_mode {mode!r} is not ported yet (ROADMAP.md queue 1, "
            "slice 3: the other sort modes)"
        )
    raise ValueError(f"unknown sort mode {mode!r}")


def sort_and_compact(batch: KVBatch, mode: str = "bitonic") -> KVBatch:
    """Group equal keys adjacently with valid rows first, carrying values
    (the reference's partition + sort, main.cu:411-415)."""
    require_mode(mode)
    lanes, values = batch.key_lanes, batch.values
    n_lanes = lanes.shape[-1]
    folded = _folded_key(batch)
    if mode == "bitonic":
        rows = torch.cat([lanes, values[:, None]], dim=1)
        key, rows = bitonic_sort_rows(folded, rows)
        lanes, values = rows[:, :n_lanes], rows[:, n_lanes]
    else:  # hashp1, and the hasht family's grouping
        order = torch.sort(packing.to_u32(folded), stable=True).indices
        key, lanes, values = folded[order], lanes[order], values[order]
    # int32 view of the folded key: valid rows are < 0x80000000, i.e. >= 0.
    return KVBatch(key_lanes=lanes, values=values, valid=key >= 0)


def _folded_key(batch: KVBatch) -> torch.Tensor:
    """ONE 32-bit sort key (int32 bit pattern): ``h1 >> 1`` for valid rows,
    0xFFFFFFFF for invalid ones."""
    h1 = packing.primary_hash(batch.key_lanes)
    folded = torch.where(batch.valid, h1 >> 1, packing.MASK32)
    return packing.to_i32(folded)
