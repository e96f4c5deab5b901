"""TF-IDF scoring: one composite-key WordCount gives tf AND df.

Port of ``locust_tpu/apps/tfidf.py``.  The emit key is (word, doc) — the
word's packed byte lanes plus ONE extra 32-bit lane carrying the doc id —
and the STANDARD Process/Reduce stages (ops/process_stage.sort_and_compact,
ops/reduce_stage.segment_reduce_into) fold those composite pairs across
blocks unchanged, because every sort mode and boundary compare is generic
over the lane count.  Under ``sort_mode="bitonic"`` each block's fold is
one launch of the bitonic kernel over ``concat(table, block)`` with
``key_lanes + 2`` payload columns; with ``cfg.use_pallas`` the map goes
through the tokenizer kernel.

From the resulting {(word, doc): tf} table both remaining quantities are
host-side folds over a table that is orders of magnitude smaller than
the corpus: df(word) = number of pairs with that word, n_docs = distinct
doc ids seen, and

    score(word, doc) = tf * ln(n_docs / df(word))

(the classic unsmoothed formulation; a df of n_docs scores 0).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.core import bytes_ops, packing
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.engine import normalize_block, resolve_device
from locust_tpu_torch.io.loader import prefetch_blocks
from locust_tpu_torch.ops.map_stage import tokenize_lines
from locust_tpu_torch.ops.process_stage import sort_and_compact
from locust_tpu_torch.ops.reduce_stage import segment_reduce_into

logger = logging.getLogger("locust_tpu_torch")


def _fold_tf_block(acc: KVBatch, lines: torch.Tensor, doc_ids: torch.Tensor,
                   cfg: EngineConfig, tsize: int):
    """Merge one block's (word, doc) -> 1 emits into the running tf table.

    The WordCount engine's fold (concat with the accumulator, ONE sort,
    segment-sum into capacity) on a batch whose key has
    ``cfg.key_lanes + 1`` lanes: the word plus a doc-id lane (lane order
    IS byte order, core/packing, so the host can split the decoded key
    back into word and doc id).  Doc ids are >= 0, so their int32 bits
    are the unsigned lane the JAX package carries.
    """
    res = tokenize_lines(lines, cfg)
    flat_keys = res.keys.reshape(-1, cfg.key_width)
    flat_valid = res.valid.reshape(-1)
    word_lanes = packing.pack_keys(flat_keys)
    docs = doc_ids.to(torch.int32).repeat_interleave(cfg.emits_per_line)
    comp = KVBatch(
        key_lanes=torch.cat([word_lanes, docs[:, None]], dim=-1),
        values=torch.ones(flat_keys.shape[0], dtype=torch.int32, device=lines.device),
        valid=flat_valid,
    )
    merged, distinct = segment_reduce_into(
        sort_and_compact(KVBatch.concat(acc, comp), cfg.sort_mode), tsize, "sum"
    )
    return merged, distinct, res.overflow


def term_doc_counts(
    lines: list[bytes] | np.ndarray,
    doc_ids: np.ndarray,
    cfg: EngineConfig | None = None,
    pairs_capacity: int | None = None,
    allow_overflow: bool = False,
    device=None,
) -> dict[tuple[bytes, int], int]:
    """Host API: lines + per-line doc ids -> {(word, doc id): count}.

    Streams fixed-shape blocks like the WordCount engine.  Exceeding
    ``pairs_capacity`` (default ``default_pairs_capacity``: 2x
    emits_per_block, floor 4096) raises, and so does dropping tokens past
    the per-line emit cap (unless ``allow_overflow=True`` downgrades that
    to a warning) — either loss makes tf-idf scores silently wrong, and a
    plain dict return has no other channel to signal it.  Runs on CUDA
    unless ``device`` says otherwise.
    """
    cfg = cfg or EngineConfig()
    if not isinstance(lines, np.ndarray):
        rows = bytes_ops.strings_to_rows(list(lines), cfg.line_width)
    else:
        rows = lines
    ids = np.asarray(doc_ids, np.int32)
    if rows.shape[0] != ids.shape[0]:
        raise ValueError(f"{rows.shape[0]} lines but {ids.shape[0]} doc ids")

    bl = cfg.block_lines
    chunks = (
        (rows[i : i + bl], ids[i : i + bl])
        for i in range(0, max(rows.shape[0], 1), bl)
    )
    return _fold_tf_chunks(chunks, cfg, pairs_capacity, allow_overflow, False,
                           resolve_device(device))


def _finish_tf(acc: KVBatch, distinct, overflow, cfg, cap,
               allow_overflow) -> dict[tuple[bytes, int], int]:
    """Shared tail of the tf folds: loss checks + host decode.

    Decodes the composite key NUMERICALLY (KVBatch.to_host_pairs would
    NUL-strip the key bytes, eating a doc-id lane whose low bytes are
    zero): word lanes -> bytes, doc lane -> int.  The lanes are int32 bit
    patterns, viewed as uint32 before the big-endian byte view.
    """
    overflow, distinct = int(overflow), int(distinct)
    if overflow:
        msg = (
            f"tf-idf dropped {overflow} tokens beyond the "
            f"{cfg.emits_per_line}-per-line cap; their counts are MISSING "
            "— raise emits_per_line"
        )
        if not allow_overflow:
            raise ValueError(msg)
        logger.warning(msg)
    if distinct > cap:
        raise ValueError(
            f"distinct (word, doc) pairs ({distinct}) exceed "
            f"pairs_capacity ({cap}); pass a larger pairs_capacity"
        )

    live = acc.valid.cpu().numpy()
    lanes = acc.key_lanes.cpu().numpy()[live].view(np.uint32)
    counts = acc.values.cpu().numpy()[live]
    n_live = lanes.shape[0]
    if n_live == 0:
        return {}
    word_bytes = lanes[:, :-1].astype(">u4").view(np.uint8).reshape(n_live, -1)
    words = bytes_ops.rows_to_strings(word_bytes)
    docs = lanes[:, -1].astype(np.int64)
    out: dict[tuple[bytes, int], int] = {}
    for word, doc, count in zip(words, docs, counts):
        pair = (word, int(doc))
        # A full-hash collision can split a pair into two table rows
        # (engine.finalize_host_pairs re-merges the same case).
        out[pair] = out.get(pair, 0) + int(count)
    return out


def term_doc_counts_stream(
    chunks,
    cfg: EngineConfig | None = None,
    pairs_capacity: int | None = None,
    allow_overflow: bool = False,
    device=None,
) -> dict[tuple[bytes, int], int]:
    """Bounded-memory tf: ``chunks`` yields ``(rows [<=block_lines, width],
    doc_ids [same length])`` pairs — e.g. zip a ``StreamingCorpus(path,
    width, cfg.block_lines)`` with a doc-id generator.  Same result and
    loss guarantees as ``term_doc_counts``; only one chunk plus the pair
    table are ever resident, and the reader prefetches ahead of the fold.
    """
    return _fold_tf_chunks(chunks, cfg or EngineConfig(), pairs_capacity,
                           allow_overflow, True, resolve_device(device))


def _fold_tf_chunks(chunks, cfg, pairs_capacity, allow_overflow, prefetch: bool,
                    device: torch.device) -> dict[tuple[bytes, int], int]:
    """The ONE tf fold loop behind both entry points (validation, padding,
    accumulate); ``prefetch`` adds the reader thread for the streaming
    path only — the in-memory path stays thread-free."""
    from locust_tpu_torch.apps.inverted_index import default_pairs_capacity

    cap = pairs_capacity or default_pairs_capacity(cfg)
    bl, w = cfg.block_lines, cfg.line_width
    acc = KVBatch.empty(cap, cfg.key_lanes + 1, device)
    # Device scalars: no host sync per block.
    distinct = torch.zeros((), dtype=torch.int32, device=device)
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    if prefetch:
        chunks = prefetch_blocks(chunks)
    try:
        for rows_chunk, ids_chunk in chunks:
            ids_chunk = np.asarray(ids_chunk, np.int32)
            rows_chunk = np.asarray(rows_chunk, np.uint8)
            if rows_chunk.shape[0] != ids_chunk.shape[0]:
                raise ValueError(
                    f"chunk has {rows_chunk.shape[0]} lines but "
                    f"{ids_chunk.shape[0]} doc ids"
                )
            if ids_chunk.size and ids_chunk.min() < 0:
                # The doc id rides an unsigned key lane; -1 would come
                # back as 2**32-1, a different key than passed in.
                raise ValueError(
                    f"doc ids must be >= 0, got min {int(ids_chunk.min())}"
                )
            rows_chunk = normalize_block(rows_chunk, bl, w)
            if ids_chunk.shape[0] < bl:
                ids_chunk = np.concatenate(
                    [ids_chunk, np.zeros(bl - ids_chunk.shape[0], np.int32)]
                )
            acc, blk_distinct, blk_overflow = _fold_tf_block(
                acc, torch.from_numpy(rows_chunk).to(device),
                torch.from_numpy(ids_chunk).to(device), cfg, cap,
            )
            distinct = torch.maximum(distinct, blk_distinct)
            overflow = overflow + blk_overflow
    finally:
        if prefetch:
            chunks.close()  # stops the reader thread, also on an exception
    return _finish_tf(acc, distinct, overflow, cfg, cap, allow_overflow)


def scores_from_tf(
    tf: dict[tuple[bytes, int], int], n_docs: int
) -> dict[tuple[bytes, int], float]:
    """The tf-table -> score fold: ``score = tf * ln(n_docs / df)`` with
    df counted over the pair table.  The ONE spelling — ``build_tfidf``
    and the plan compiler's ``tfidf_score`` stage (plan/compile.py) both
    call it.  Host float64, so both packages score the same bits."""
    df: dict[bytes, int] = {}
    for word, _ in tf:
        df[word] = df.get(word, 0) + 1
    return {
        (word, doc): count * math.log(n_docs / df[word])
        for (word, doc), count in tf.items()
    }


def build_tfidf(
    lines: list[bytes] | np.ndarray,
    doc_ids: np.ndarray,
    cfg: EngineConfig | None = None,
    pairs_capacity: int | None = None,
    allow_overflow: bool = False,
    device=None,
) -> dict[tuple[bytes, int], float]:
    """{(word, doc id): tf-idf score} over line-sharded documents.

    ``score = tf * ln(n_docs / df)`` — tf from the device pair table,
    df and n_docs as host folds over that same (already tiny) table.
    """
    ids = np.asarray(doc_ids, np.int32)
    tf = term_doc_counts(lines, ids, cfg, pairs_capacity, allow_overflow, device)
    n_docs = len(set(int(d) for d in ids)) or 1
    return scores_from_tf(tf, n_docs)
