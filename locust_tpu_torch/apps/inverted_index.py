"""Inverted index: word -> sorted unique doc ids.

Port of the single-device part of ``locust_tpu/apps/inverted_index.py``
(``DistributedInvertedIndex`` and ``build_inverted_index_mesh`` wait for
the port's mesh tier).  Emits are (word, doc_id) and the reduce is
"collect the distinct values per key", a variable-length output over
fixed-slot emits:

  1. Map: tokenize lines (ops/map_stage; the tokenizer kernel when
     ``cfg.use_pallas``), value = the line's doc id.
  2. Sort by (validity, hash64(key), value): the 64-bit grouping hash of
     the Process stage's "hash" mode, extended with the value as the
     least significant key so each word's doc ids come out ascending.
     JAX's 4-key ``lax.sort`` becomes ``process_stage._lexsort``: stable
     torch sorts over unsigned keys in int64, the int32 value with its
     sign bit flipped so that unsigned order is JAX's signed order.  Rows
     that tie on all four keys are equal pairs, so the order between
     them (JAX's sort is not stable) cannot change the deduped table.
  3. Dedup (word, doc) pairs with a boundary mask on pair equality, then
     one more sort pushes the surviving pairs to the prefix.
  4. Word segment boundaries over the deduped prefix give the postings
     offsets: the index is (concatenated doc-id postings, per-word
     counts), assembled on the host into {word: [doc ids]}.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.core import bytes_ops, packing
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.engine import resolve_device
from locust_tpu_torch.ops.map_stage import tokenize_lines
from locust_tpu_torch.ops.process_stage import _lexsort
from locust_tpu_torch.ops.reduce_stage import segment_reduce

logger = logging.getLogger("locust_tpu_torch")


def _sort_pairs(batch: KVBatch) -> KVBatch:
    """Group by (validity, hash64(key)) with values as a tie-break sort
    key: 4 sort keys regardless of key width, rows gathered after."""
    lanes, values, valid = batch.key_lanes, batch.values, batch.valid
    h1, h2 = packing.hash_pair(lanes)
    order = _lexsort([
        (~valid).to(torch.int64),
        packing.to_u32(h1),
        packing.to_u32(h2),
        values.to(torch.int64) + 0x80000000,  # signed order, as unsigned keys
    ])
    return KVBatch(key_lanes=lanes[order], values=values[order], valid=valid[order])


def _dedup_sorted_pairs(s: KVBatch) -> tuple[KVBatch, torch.Tensor]:
    """Mark the first of each identical (word, doc) run; return the
    re-compacted batch and the surviving-pair count."""
    n = s.size
    prev_lanes = torch.roll(s.key_lanes, 1, dims=0)
    prev_vals = torch.roll(s.values, 1)
    first = torch.arange(n, device=s.values.device) == 0
    pair_new = first | (s.key_lanes != prev_lanes).any(dim=-1) | (s.values != prev_vals)
    keep = s.valid & pair_new
    deduped = KVBatch(key_lanes=s.key_lanes, values=s.values, valid=keep)
    d = _sort_pairs(deduped)  # compact survivors to the prefix, still ordered
    return d, keep.sum(dtype=torch.int32)


def _fold_index_block(acc: KVBatch, lines: torch.Tensor, doc_ids: torch.Tensor,
                      cfg: EngineConfig, cap: int):
    """Merge one block's (word, doc) pairs into the running deduped table:
    the WordCount engine's one-fold-per-block shape, but the carried state
    is the PAIR set, which the final segment count turns into postings."""
    res = tokenize_lines(lines, cfg)
    flat_keys = res.keys.reshape(-1, cfg.key_width)
    flat_valid = res.valid.reshape(-1)
    values = doc_ids.to(torch.int32).repeat_interleave(cfg.emits_per_line)
    batch = KVBatch.from_bytes(flat_keys, values, flat_valid)

    d, n_pairs = _dedup_sorted_pairs(_sort_pairs(KVBatch.concat(acc, batch)))
    head = KVBatch(key_lanes=d.key_lanes[:cap], values=d.values[:cap], valid=d.valid[:cap])
    return head, n_pairs, res.overflow


def default_pairs_capacity(cfg: EngineConfig, mult: int = 2) -> int:
    """Default distinct-(word, doc) pair capacity: ``mult`` rounds of
    emits with a 4096 floor.  The pair table is CORPUS-level state, not
    per-block — a small block size must not shrink it.  The ONE sizing
    rule of the index and the tf counter (the JAX package's mesh index
    passes ``mult=4``)."""
    return max(mult * cfg.emits_per_block, 4096)


def build_inverted_index(
    lines: list[bytes] | np.ndarray,
    doc_ids: np.ndarray,
    cfg: EngineConfig | None = None,
    pairs_capacity: int | None = None,
    device=None,
) -> dict[bytes, list[int]]:
    """Host API: lines + per-line doc ids -> {word: sorted unique doc ids}.

    Streams the corpus through fixed-shape blocks like the WordCount
    engine — no line-count cap.  ``pairs_capacity`` bounds the distinct
    (word, doc) pair table carried across blocks (default
    ``default_pairs_capacity``: 2x emits_per_block, floor 4096);
    exceeding it raises, since a truncated index is silently wrong.  Runs
    on CUDA unless ``device`` says otherwise.
    """
    cfg = cfg or EngineConfig()
    dev = resolve_device(device)
    cap = pairs_capacity or default_pairs_capacity(cfg)
    if not isinstance(lines, np.ndarray):
        rows = bytes_ops.strings_to_rows(list(lines), cfg.line_width)
    else:
        rows = lines
    ids = np.asarray(doc_ids, np.int32)
    if rows.shape[0] != ids.shape[0]:
        raise ValueError(f"{rows.shape[0]} lines but {ids.shape[0]} doc ids")

    bl = cfg.block_lines
    nblocks = max(1, -(-rows.shape[0] // bl))
    pad = nblocks * bl - rows.shape[0]
    rows = np.concatenate([rows, np.zeros((pad, cfg.line_width), np.uint8)])
    ids = np.concatenate([ids, np.zeros(pad, np.int32)])
    # One copy each to the device.
    blocks = torch.from_numpy(rows).to(dev).reshape(nblocks, bl, cfg.line_width)
    id_blocks = torch.from_numpy(ids).to(dev).reshape(nblocks, bl)

    acc = KVBatch.empty(cap, cfg.key_lanes, dev)
    # The counters stay on the device across the loop; the capacity check
    # reads them once, after.
    n_pairs = torch.zeros((), dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    for blk, blk_ids in zip(blocks, id_blocks):
        acc, blk_pairs, blk_overflow = _fold_index_block(acc, blk, blk_ids, cfg, cap)
        n_pairs = torch.maximum(n_pairs, blk_pairs)
        overflow = overflow + blk_overflow
    n_pairs, overflow = int(n_pairs), int(overflow)
    if overflow:
        # Missing postings make a silently-wrong index; say so loudly.
        logger.warning(
            "inverted index dropped %d tokens beyond the %d-per-line cap; "
            "their postings are MISSING — raise emits_per_line",
            overflow,
            cfg.emits_per_line,
        )
    if n_pairs > cap:
        raise ValueError(
            f"distinct (word, doc) pairs ({n_pairs}) exceed pairs_capacity "
            f"({cap}); pass a larger pairs_capacity"
        )
    counts = segment_reduce(acc, "count")

    # Host assembly: postings prefix + per-word counts -> dict.
    live_vals = acc.values.cpu().numpy()[acc.valid.cpu().numpy()]
    out: dict[bytes, list[int]] = {}
    pos = 0
    for word, cnt in counts.to_host_pairs():
        run = [int(v) for v in live_vals[pos : pos + cnt]]
        if word in out:  # 64-bit hash collision split a word into two runs
            run = sorted(set(out[word] + run))
        out[word] = run
        pos += cnt
    if pos != len(live_vals):
        raise RuntimeError("postings/count bookkeeping diverged")
    return out
