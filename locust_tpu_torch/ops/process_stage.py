"""Process stage: compaction + key-grouping sort in one sort.

Port of ``locust_tpu/ops/process_stage.py``, every ``sort_mode``.  Each
mode sorts so that valid rows come first and equal keys lie adjacent,
carrying the values:

* **"lex"**: keys ``(invalid, lane_0 .. lane_{L-1})``: valid rows in
  lexicographic key order.
* **"hash"** / **"hashp"**: keys ``(invalid, h1, h2)`` from
  ``packing.hash_pair``; the rows gathered (hash) or carried (hashp)
  into place, which in torch is one gather either way.
* **"hashp2"**: keys ``(folded, h2)``, validity in the folded key's top bit.
* **"hashp1"** / **"hash1"**: the single folded key.
* **"radix"**: the folded key through ``ops/radix_sort.radix_argsort``.
* **"bitonic"**: the hand-written bitonic sort (ops/kernels/sort.py) over
  the folded key, with the row (key lanes + value) as payload.

The hasht family (config.HASHT_FAMILY) is a fold-level strategy
(ops/hash_table.aggregate_exact); the consumers of this grouping
interface (``timed_run``'s split stages, the staged CLI's reduce, the
residual sorts of the hasht ladder) get "hashp1" for it, as in JAX.

A multi-key ``lax.sort`` becomes successive stable ``torch.sort``s from
the least significant key up, on keys widened to int64 (``_lexsort``).
JAX's multi-key sorts need not be stable, so rows whose sort keys are
all equal may come out in another order in either package; hashp1 and
radix are stable in both.  The folded key is 31 hash bits with the
invalid rows at 0xFFFFFFFF, so ascending unsigned order is "valid rows
first, equal keys adjacent".  Distinct keys that share a folded key may
interleave; the segment reduce compares full key lanes, so that only
splits a key into duplicate table rows, which the next fold or the host
finalize re-merges.
"""

from __future__ import annotations

import torch

from locust_tpu_torch.config import HASHT_FAMILY
from locust_tpu_torch.core import packing
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.ops.kernels.sort import bitonic_sort_rows
from locust_tpu_torch.ops.radix_sort import radix_argsort


def sort_and_compact(batch: KVBatch, mode: str = "bitonic") -> KVBatch:
    """Group equal keys adjacently with valid rows first, carrying values
    (the reference's partition + sort, main.cu:411-415)."""
    if mode == "bitonic":
        return _bitonic_sort(batch)
    if mode in ("hashp1", "hash1", *HASHT_FAMILY):
        order = _lexsort([packing.to_u32(_folded_key(batch))])
    elif mode in ("hash", "hashp"):
        h1, h2 = packing.hash_pair(batch.key_lanes)
        invalid = (~batch.valid).to(torch.int64)
        order = _lexsort([invalid, packing.to_u32(h1), packing.to_u32(h2)])
    elif mode == "hashp2":
        _, h2 = packing.hash_pair(batch.key_lanes)
        order = _lexsort([packing.to_u32(_folded_key(batch)), packing.to_u32(h2)])
    elif mode == "lex":
        lanes = packing.to_u32(batch.key_lanes)
        invalid = (~batch.valid).to(torch.int64)
        order = _lexsort([invalid, *lanes.unbind(dim=1)])
    elif mode == "radix":
        order = radix_argsort(_folded_key(batch))
    else:
        raise ValueError(f"unknown sort mode {mode!r}")
    return KVBatch(
        key_lanes=batch.key_lanes[order], values=batch.values[order], valid=batch.valid[order]
    )


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable ascending order of rows by unsigned 32-bit ``keys`` (int64
    tensors in ``[0, 2^32)``), most significant first: one stable sort
    per pair of keys, least significant pair first.  A pair shares one
    int64 key, the high key with its sign bit flipped so that signed
    int64 order is the pair's unsigned order."""
    order = None
    for i in range(len(keys), 0, -2):
        lo = keys[i - 1]
        key = lo if i == 1 else (keys[i - 2] - 0x80000000) * 0x100000000 + lo
        if order is None:
            order = torch.sort(key, stable=True).indices
        else:
            order = order[torch.sort(key[order], stable=True).indices]
    return order


def _bitonic_sort(batch: KVBatch) -> KVBatch:
    lanes, values = batch.key_lanes, batch.values
    n_lanes = lanes.shape[-1]
    rows = torch.cat([lanes, values[:, None]], dim=1)
    key, rows = bitonic_sort_rows(_folded_key(batch), rows)
    # int32 view of the folded key: valid rows are < 0x80000000, i.e. >= 0.
    return KVBatch(key_lanes=rows[:, :n_lanes], values=rows[:, n_lanes], valid=key >= 0)


def _folded_key(batch: KVBatch) -> torch.Tensor:
    """ONE 32-bit sort key (int32 bit pattern): ``h1 >> 1`` for valid rows,
    0xFFFFFFFF for invalid ones."""
    h1 = packing.primary_hash(batch.key_lanes)
    folded = torch.where(batch.valid, h1 >> 1, packing.MASK32)
    return packing.to_i32(folded)
