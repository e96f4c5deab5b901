"""Inverted index: word -> sorted unique doc ids.

Port of ``locust_tpu/apps/inverted_index.py``; the mesh variant
(``DistributedInvertedIndex``, ``build_inverted_index_mesh``) runs one
rank per process on ``locust_tpu_torch.parallel``.  Emits are (word,
doc_id) and the reduce is
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


class DistributedInvertedIndex:
    """Mesh-parallel inverted index, one rank per process.

    The collective recipe of ``parallel/shuffle.DistributedMapReduce`` —
    hash-partition, equal bins, one all-to-all per round, carried
    per-rank state, lossless backlog retry — but the shuffled unit is the
    (word, doc) PAIR and the per-shard merge is a dedup, not a segment
    reduce.  Partitioning hashes the WORD only, so every posting of a
    word lands on one shard and host assembly is a plain per-shard union.
    Each round a rank tokenizes its lines (kernel A when
    ``cfg.use_pallas``), dedupes its pairs locally, partitions them with
    the backlog into bins, exchanges the bins and merges what it received
    into its pair table; the backlog drains in further all-to-all rounds,
    its sum over the ranks read once a round on the host, so every rank
    takes the same number of trips (the JAX step's ``while_loop``).
    Integers only cross ranks, so every sum is exact in any order.
    """

    def __init__(self, mesh, cfg: EngineConfig, axis_name: str | None = None,
                 skew_factor: float = 2.0, pairs_capacity: int | None = None):
        from locust_tpu_torch.parallel.mesh import DATA_AXIS
        from locust_tpu_torch.parallel.shuffle import sized_bins

        axis = axis_name or DATA_AXIS
        self.mesh = mesh
        self.cfg = cfg
        self.axis = axis
        self.n_dev = mesh.shape[axis]
        self.bin_capacity = sized_bins(cfg.emits_per_block, self.n_dev, skew_factor)
        self.leftover_capacity = cfg.emits_per_block
        # Distinct (word, doc) pairs carried per shard; exceeding it raises.
        # Pairs accumulate across ALL rounds, so the floor is larger than
        # one round's emits.
        self.pairs_capacity = pairs_capacity or default_pairs_capacity(cfg, mult=4)
        self.max_drain_rounds = 2 + -(-cfg.emits_per_block // self.bin_capacity)

    @property
    def lines_per_round(self) -> int:
        return self.n_dev * self.cfg.block_lines

    def _shuffle_round(self, local: KVBatch, acc: KVBatch, leftover: KVBatch):
        """One partition + all-to-all + dedup-merge; feed and drain share
        it.  Returns ``(acc, leftover, shuffle overflow, distinct pairs,
        this rank's backlog)``, the counts int32 scalars on the device."""
        from locust_tpu_torch.parallel.shuffle import exchange_bins, partition_packed

        bins, shuf_ovf, new_left, _ = partition_packed(
            KVBatch.concat(local, leftover), self.n_dev, self.bin_capacity,
            leftover_capacity=self.leftover_capacity,
        )
        received = exchange_bins(self.mesh, self.axis, bins)
        merged, n_pairs = _dedup_sorted_pairs(_sort_pairs(KVBatch.concat(acc, received)))
        cap = self.pairs_capacity
        new_acc = KVBatch(merged.key_lanes[:cap], merged.values[:cap], merged.valid[:cap])
        return new_acc, new_left, shuf_ovf, n_pairs, new_left.valid.sum(dtype=torch.int32)

    def _step(self, lines: torch.Tensor, doc_ids: torch.Tensor, acc: KVBatch,
              leftover: KVBatch):
        """Feed + drain of one round on this rank: ``(acc, leftover,
        stats)``, stats ``[emit overflow, shuffle overflow, worst shard's
        distinct pairs, backlog, drains]`` (int32 on the device, the same
        on every rank)."""
        cfg, mesh, axis = self.cfg, self.mesh, self.axis
        dev = lines.device
        res = tokenize_lines(lines, cfg)
        flat_keys = res.keys.reshape(-1, cfg.key_width)
        flat_valid = res.valid.reshape(-1)
        values = doc_ids.to(torch.int32).repeat_interleave(cfg.emits_per_line)
        batch = KVBatch.from_bytes(flat_keys, values, flat_valid)
        # Local pre-dedup: repeated (word, doc) pairs within the shard
        # collapse before touching the network (the combiner analog).
        local, _ = _dedup_sorted_pairs(_sort_pairs(batch))
        acc, leftover, shuf_ovf, n_pairs, backlog = self._shuffle_round(local, acc, leftover)
        backlog = mesh.all_reduce(backlog, axis)
        drains = 0
        zero_local = KVBatch.empty(local.size, cfg.key_lanes, dev)
        while int(backlog) > 0 and drains < self.max_drain_rounds:  # locust: noqa[R003] the drain loop's condition, one read per round, equal on every rank (all-reduced): JAX's lax.while_loop (apps/inverted_index.py:293-310) is a host loop here
            acc, leftover, so, n_pairs, backlog = self._shuffle_round(zero_local, acc, leftover)
            shuf_ovf = shuf_ovf + so
            backlog = mesh.all_reduce(backlog, axis)
            drains += 1
        summed = mesh.all_reduce(torch.stack([res.overflow.to(torch.int32), shuf_ovf]), axis)
        worst = mesh.all_reduce(n_pairs.reshape(1), axis, op="max")
        stats = torch.cat([summed, worst, backlog.reshape(1),
                           torch.tensor([drains], dtype=torch.int32, device=dev)])
        return acc, leftover, stats

    def run(self, lines: list[bytes] | np.ndarray, doc_ids: np.ndarray,
            stats_sync_every: int = 16, checkpoint_dir: str | None = None,
            checkpoint_every: int = 1) -> dict[bytes, list[int]]:
        """The whole corpus (host rows or lines, the same on every rank)
        -> {word: sorted unique doc ids}, on every rank.  With
        ``checkpoint_dir``, the gathered pair table, backlog and counters
        land in one npz per process every ``checkpoint_every`` rounds, and
        a re-run of the same corpus resumes after the last one."""
        cfg = self.cfg
        if not isinstance(lines, np.ndarray):
            rows = bytes_ops.strings_to_rows(list(lines), cfg.line_width)
        else:
            rows = lines
        ids = np.asarray(doc_ids, np.int32)
        if rows.shape[0] != ids.shape[0]:
            raise ValueError(f"{rows.shape[0]} lines but {ids.shape[0]} doc ids")

        lpr = self.lines_per_round
        nrounds = max(1, -(-rows.shape[0] // lpr))
        chunks = ((rows[r * lpr:(r + 1) * lpr], ids[r * lpr:(r + 1) * lpr])
                  for r in range(nrounds))
        fingerprint = None
        if checkpoint_dir is not None:
            from locust_tpu_torch.io.serde import fingerprint_corpus

            # Doc ids are part of the corpus identity: the same lines with
            # different sharding produce a different index.
            fingerprint = fingerprint_corpus(
                rows, doc_ids=fingerprint_corpus(ids), **self._identity())
        return self._run_rounds(chunks, stats_sync_every, fingerprint=fingerprint,
                                checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every)

    def _identity(self) -> dict:
        """Engine, pipeline and mesh identity bound into checkpoint
        fingerprints; equal to the JAX index's for the same configuration."""
        return dict(
            engine="inverted_index",
            cfg=repr(self.cfg),
            mesh=f"{self.n_dev}x{self.axis}",
            bin_capacity=self.bin_capacity,
            pairs_capacity=self.pairs_capacity,
        )

    def run_stream(self, blocks, stats_sync_every: int = 16, fingerprint: str | None = None,
                   checkpoint_dir: str | None = None,
                   checkpoint_every: int = 1) -> dict[bytes, list[int]]:
        """Bounded-memory variant: ``blocks`` yields ``(rows [<=
        lines_per_round, width], doc_ids [same length])`` chunk pairs.
        Only one chunk plus the sharded pair table are ever resident.
        Pass a corpus ``fingerprint`` to checkpoint and resume."""
        from locust_tpu_torch.io.loader import prefetch_blocks
        from locust_tpu_torch.parallel.shuffle import stream_checkpoint_fingerprint

        fingerprint = stream_checkpoint_fingerprint(fingerprint, checkpoint_dir,
                                                    self._identity())
        return self._run_rounds(prefetch_blocks(blocks), stats_sync_every,
                                fingerprint=fingerprint, checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every)

    def _run_rounds(self, chunk_iter, stats_sync_every: int, fingerprint: str | None = None,
                    checkpoint_dir: str | None = None, checkpoint_every: int = 1):
        from locust_tpu_torch.parallel.mesh import scatter_host_array, shard_rows
        from locust_tpu_torch.parallel.shuffle import (
            RoundStats,
            ShardedCheckpoint,
            drive_checkpointed_rounds,
            gather_batch_host,
            normalize_round_chunk,
        )

        cfg, mesh = self.cfg, self.mesh
        lpr, width = self.lines_per_round, cfg.line_width
        acc = KVBatch.empty(self.pairs_capacity, cfg.key_lanes, mesh.device)
        leftover = KVBatch.empty(self.leftover_capacity, cfg.key_lanes, mesh.device)
        counters = dict(n_pairs=0, shuf_ovf=0, emit_ovf=0)
        start_round = 0

        ckpt = None
        if checkpoint_dir is not None:
            ckpt = ShardedCheckpoint(checkpoint_dir, fingerprint, mesh,
                                     async_writes=cfg.async_checkpoint)
            restored = ckpt.load()
            if restored is not None:
                start_round, extras, acc, leftover = restored
                for k in counters:
                    counters[k] = int(extras[k])

        def snapshot(next_round: int) -> None:
            ckpt.snapshot(next_round, acc, leftover,
                          **{k: np.int64(v) for k, v in counters.items()})

        def on_sync(st) -> None:
            counters["emit_ovf"] += int(st[0])
            counters["shuf_ovf"] += int(st[1])
            counters["n_pairs"] = max(counters["n_pairs"], int(st[2]))
            backlog = int(st[3])
            if backlog > 0:
                raise RuntimeError(
                    f"index backlog failed to drain in {self.max_drain_rounds} rounds "
                    f"({backlog} pairs remain); raise skew_factor")
            if counters["shuf_ovf"]:
                raise RuntimeError(
                    f"index shuffle lost {counters['shuf_ovf']} pairs; "
                    "emits exceeded cfg.emits_per_block")

        def merge(a, b):
            # Overflows and drains add, worst-shard pairs take the maximum,
            # the backlog the later round's.
            return torch.stack([a[0] + b[0], a[1] + b[1], torch.maximum(a[2], b[2]), b[3],
                                a[4] + b[4]])

        round_stats = RoundStats(merge, on_sync, stats_sync_every)

        def fold_round(chunk) -> None:
            nonlocal acc, leftover
            rows_chunk, ids_chunk = chunk
            ids_chunk = np.asarray(ids_chunk, dtype=np.int32)
            rows_chunk = np.asarray(rows_chunk, dtype=np.uint8)
            if rows_chunk.shape[0] != ids_chunk.shape[0]:
                raise ValueError(f"chunk has {rows_chunk.shape[0]} lines but "
                                 f"{ids_chunk.shape[0]} doc ids")
            rows_chunk = normalize_round_chunk(rows_chunk, lpr, width)
            if ids_chunk.shape[0] < lpr:
                ids_chunk = np.concatenate([ids_chunk, np.zeros(lpr - ids_chunk.shape[0],
                                                                np.int32)])
            acc, leftover, stats = self._step(shard_rows(rows_chunk, mesh),
                                              scatter_host_array(ids_chunk, mesh), acc, leftover)
            round_stats.push(stats)

        drive_checkpointed_rounds(chunk_iter, fold_round, round_stats, ckpt, snapshot,
                                  checkpoint_every, start_round)
        if counters["emit_ovf"]:
            # Missing postings make a silently-wrong index; say so loudly.
            logger.warning(
                "inverted index dropped %d tokens beyond the %d-per-line "
                "cap; their postings are MISSING — raise emits_per_line",
                counters["emit_ovf"],
                cfg.emits_per_line,
            )
        if counters["n_pairs"] > self.pairs_capacity:
            raise ValueError(
                f"distinct (word, doc) pairs per shard ({counters['n_pairs']}) exceed "
                f"pairs_capacity ({self.pairs_capacity}); pass a larger one"
            )

        # Host assembly: shards are disjoint by word (hash partition) and
        # internally (hash, doc)-sorted and deduped, so a plain grouping
        # union yields ascending unique doc ids per word.
        out: dict[bytes, list[int]] = {}
        for k, v in gather_batch_host(acc, mesh).to_host_pairs():
            out.setdefault(k, []).append(int(v))
        return out


def build_inverted_index_mesh(lines: list[bytes] | np.ndarray, doc_ids: np.ndarray, mesh,
                              cfg: EngineConfig | None = None, **kw) -> dict[bytes, list[int]]:
    """Mesh convenience wrapper: build the index across every rank."""
    return DistributedInvertedIndex(mesh, cfg or EngineConfig(), **kw).run(lines, doc_ids)
