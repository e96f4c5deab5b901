"""The distributed shuffle: hash-partition, all-to-all, per-shard reduce.

Port of ``locust_tpu/parallel/shuffle.py`` onto ``torch.distributed``, one
rank per process (parallel/mesh.py).  Each round, every rank:

  1. maps its ``cfg.block_lines`` lines of the round (kernel A when
     ``cfg.use_pallas``) and combines them locally: ``reduce_into`` in the
     sort modes (kernel B under ``bitonic``), ``combine_or_passthrough``
     in the hasht family, or, under ``fused`` on a CUDA rank, kernel C's
     pre-aggregation of the shard (the stock combine again when its flag
     is set).  Hot keys collapse to one row per rank before the network;
  2. hash-partitions the combined rows (``fold_hash % n``) into
     equal-capacity bins, the overspill into a leftover buffer;
  3. exchanges the bins with ONE ``all_to_all_single`` (lanes, values and
     valid packed in one int32 tensor, as the partition writes them);
  4. folds what it received into its shard of the table (``fold_into``;
     kernel B under ``bitonic``);
  5. drains the leftover in further all-to-all rounds until every rank's
     backlog is empty, and stacks the round's stats.

The drain loop is the JAX step's ``lax.while_loop``: each shuffle round
all-reduces the backlog over the shuffle group and reads it ONCE on the
host, so every rank of the group takes the same number of trips and the
collectives stay in lockstep (one host read per shuffle round; the fused
flag is a second, per rank).  ``drain_rounds`` therefore equals JAX's.
Stats reach the host every ``stats_sync_every`` rounds
(``RoundStats``), as in the JAX engine.

Checkpoints (``ShardedCheckpoint``) are the JAX package's: one npz per
process, ``state.p{rank}.npz`` with its ``.prev.npz`` generation, the
gathered FULL table and backlog, the same keys, dtypes and content
digest, and fingerprints bound to the same engine identity, so a port
world resumes a JAX run of the same process layout and the reverse.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from locust_tpu_torch.config import HASHT_FAMILY, EngineConfig
from locust_tpu_torch.core import packing
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.io.snapshot import AsyncCheckpointWriter, finalize_snapshot
from locust_tpu_torch.ops.hash_table import (
    combine_or_passthrough,
    fold_into,
    reduce_into,
    scatter_impl_for,
)
from locust_tpu_torch.ops.kernels.partition import stable_partition
from locust_tpu_torch.ops.map_stage import wordcount_map
from locust_tpu_torch.ops.reduce_stage import normalize_combine
from locust_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    gather_host_array,
    scatter_host_array,
    shard_rows,
)

logger = logging.getLogger("locust_tpu_torch")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def sized_bins(total_rows: int, n_bins: int, skew_factor: float) -> int:
    """Default per-destination bin capacity: a fair share of
    ``total_rows`` across ``n_bins``, padded for skew, a multiple of 8."""
    return _round_up(max(1, math.ceil(total_rows / n_bins * skew_factor)), 8)


def normalize_round_chunk(chunk, lpr: int, width: int):
    """Validate one round's host chunk and zero-pad it to ``[lpr, width]``
    uint8.  Wider rows or more rows than a round holds are the caller's
    error."""
    from locust_tpu_torch.engine import normalize_block

    chunk = np.asarray(chunk, dtype=np.uint8)
    if chunk.ndim == 2 and chunk.shape[0] > lpr:
        raise ValueError(
            f"round chunk has {chunk.shape[0]} rows, more than its round "
            f"capacity of {lpr} (engine block_lines / mesh lines_per_round);"
            " size stream blocks to match"
        )
    return normalize_block(chunk, lpr, width)


def checkpoint_digest(arrays: dict) -> str:
    """Content sha256 over a snapshot's payload entries, key-ordered:
    dtype, shape and raw bytes of each (the JAX package's digest)."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        v = np.asarray(arrays[k])
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
    return h.hexdigest()


class CheckpointInvalid(RuntimeError):
    """A snapshot file failed validation (corrupt/truncated/mismatched)."""


def _batch_to_host(table: KVBatch, mesh: Mesh, axis: str | None = None) -> dict:
    """Every rank's shard gathered: the JAX package's numpy form."""
    return {
        "key_lanes": gather_host_array(table.key_lanes, mesh, axis).view(np.uint32),
        "values": gather_host_array(table.values, mesh, axis),
        "valid": gather_host_array(table.valid, mesh, axis),
    }


def gather_batch_host(table: KVBatch, mesh: Mesh, axis: str | None = None) -> KVBatch:
    """Every rank's shard of ``table`` gathered (along ``axis``; the whole
    world when None) into one CPU batch, on every rank."""
    host = _batch_to_host(table, mesh, axis)
    return KVBatch(torch.from_numpy(host["key_lanes"].view(np.int32)),
                   torch.from_numpy(host["values"]), torch.from_numpy(host["valid"]))


def _batch_from_host(lanes, values, valid, mesh: Mesh) -> KVBatch:
    """This rank's shard of a host-replicated full table."""
    return KVBatch(
        key_lanes=scatter_host_array(np.ascontiguousarray(lanes, np.uint32).view(np.int32), mesh),
        values=scatter_host_array(np.asarray(values, np.int32), mesh),
        valid=scatter_host_array(np.asarray(valid, bool), mesh),
    )


class ShardedCheckpoint:
    """Per-process atomic-npz snapshots of a mesh engine's sharded state.

    A snapshot holds the gathered accumulator and shuffle backlog, the
    round cursor, the run's fingerprint and the engine's host counters;
    every snapshot embeds a content sha256 and keeps the previous
    generation as ``<state>.prev.npz``.  ``load`` validates before it
    trusts: an unreadable archive, a digest mismatch or a foreign
    fingerprint falls back to the previous generation, then to a fresh
    start.  Writes go to the bounded background writer when
    ``async_writes`` in a world of one; a larger world writes in the
    round loop on every rank (the gather is a collective, and per-process
    latest-wins writers could publish different generations per rank).
    """

    def __init__(self, checkpoint_dir: str, fingerprint: str, mesh: Mesh,
                 async_writes: bool = False):
        import os

        os.makedirs(checkpoint_dir, exist_ok=True)
        self.path = os.path.join(checkpoint_dir, f"state.p{mesh.rank}.npz")
        self.prev_path = self.path + ".prev.npz"
        self.fingerprint = fingerprint
        self.mesh = mesh
        self._writer = (
            AsyncCheckpointWriter(name="sharded-ckpt-writer")
            if async_writes and mesh.size == 1
            else None
        )

    def load(self):
        """``(start_round, extras, acc, leftover)`` from the newest valid
        matching snapshot (current, else previous generation), or None."""
        import os

        for path, label in ((self.path, "checkpoint"),
                            (self.prev_path, "previous-generation checkpoint")):
            if not os.path.exists(path):
                continue
            try:
                return self._load_validated(path)
            except CheckpointInvalid as e:
                logger.warning("%s at %s unusable (%s); falling back", label, path, e)
        return None

    def _load_validated(self, path: str):
        try:
            with np.load(path) as z:
                host = {k: z[k] for k in z.files}
        except Exception as e:  # noqa: BLE001 - truncated/garbled zip, bad header, ...
            raise CheckpointInvalid(f"unreadable npz: {type(e).__name__}: {e}")
        try:
            fingerprint = str(host.pop("fingerprint"))
            recorded = str(host.pop("checksum"))
            payload = dict(host)
            start_round = int(host.pop("next_round"))
            acc = [host.pop(f"acc_{k}") for k in ("key_lanes", "values", "valid")]
            left = [host.pop(f"left_{k}") for k in ("key_lanes", "values", "valid")]
        except KeyError as e:
            raise CheckpointInvalid(f"snapshot missing entry {e}")
        if checkpoint_digest(payload) != recorded:
            raise CheckpointInvalid("content sha256 mismatch (bit-rot?)")
        if fingerprint != self.fingerprint:
            raise CheckpointInvalid("belongs to a different run")
        logger.info("resuming from checkpoint at round %d (%s)", start_round, path)
        return (start_round, dict(host), _batch_from_host(*acc, self.mesh),
                _batch_from_host(*left, self.mesh))

    def snapshot(self, next_round: int, acc: KVBatch, leftover: KVBatch, **extras) -> None:
        """One atomically replaced npz: table, backlog, cursor and counters
        never tear apart; the outgoing generation survives as ``.prev.npz``."""
        if self._writer is None:
            self._write(next_round, _batch_to_host(acc, self.mesh),
                        _batch_to_host(leftover, self.mesh), extras)
            return
        # A world of one: the gather is a plain copy, taken off the loop.
        snap = [acc.clone(), leftover.clone()]
        ready = None
        if self.mesh.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.mesh.device))

        def write():
            if ready is not None:
                ready.synchronize()  # locust: noqa[R003] runs in write() on the snapshot writer's thread, not in the round loop: waits for the snapshot copy's event
            self._write(next_round, _batch_to_host(snap[0], self.mesh),
                        _batch_to_host(snap[1], self.mesh), extras)

        self._writer.submit(next_round, write)

    def _write(self, next_round: int, acc_h: dict, left_h: dict, extras: dict) -> None:
        payload = {f"acc_{k}": v for k, v in acc_h.items()}
        payload.update({f"left_{k}": v for k, v in left_h.items()})
        payload["next_round"] = np.int64(next_round)
        payload.update(extras)
        tmp = self.path + ".tmp.npz"
        np.savez_compressed(
            tmp,
            fingerprint=np.str_(self.fingerprint),
            checksum=np.str_(checkpoint_digest(payload)),
            **payload,
        )
        # Rotation, the io.ckpt_write fault site, the atomic replace and
        # the io.checkpoint damage site, shared with the engine's writer.
        finalize_snapshot(tmp, self.path, prev_path=self.prev_path, generation=next_round)

    def flush(self) -> None:
        """Wait for the last submitted generation; re-raises writer errors."""
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


def stream_checkpoint_fingerprint(fingerprint: str | None, checkpoint_dir: str | None,
                                  identity: dict) -> str | None:
    """The run_stream fingerprint rule: checkpointing needs an explicit
    corpus fingerprint, and the engine's identity is bound into it."""
    if checkpoint_dir is not None and fingerprint is None:
        raise ValueError(
            "run_stream needs an explicit corpus fingerprint to "
            "checkpoint (e.g. StreamingCorpus.fingerprint())"
        )
    if fingerprint is not None:
        fingerprint = f"{fingerprint}:{identity}"
    return fingerprint


def drive_checkpointed_rounds(chunk_iter, body, round_stats: "RoundStats",
                              ckpt: ShardedCheckpoint | None, snapshot,
                              checkpoint_every: int, start_round: int) -> None:
    """The loop half of the snapshot protocol, one copy for every round
    engine: skip the rounds a resume already folded, flush the stats
    before each snapshot, snapshot every ``checkpoint_every`` rounds and
    once more at the end if rounds ran past the last one, flush the
    writer on the normal path and close it in ``finally``."""
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    last_snapshot = nrounds = start_round
    try:
        for r, chunk in enumerate(chunk_iter):
            if r < start_round:  # resume: re-read, don't re-fold
                continue
            nrounds = r + 1
            body(chunk)
            if ckpt is not None and (r + 1) % checkpoint_every == 0:
                round_stats.flush()
                snapshot(r + 1)
                last_snapshot = r + 1
        round_stats.flush()
        if ckpt is not None and last_snapshot != nrounds:
            snapshot(nrounds)
        if ckpt is not None:
            ckpt.flush()
    finally:
        if ckpt is not None:
            ckpt.close()


class RoundStats:
    """Stats vectors merged on the device round after round, read on the
    host every ``every`` rounds, when ``on_sync(host_row)`` folds them
    into host counters and polices the invariants.  ``fetch_fn`` replaces
    the device-to-host read (the hierarchical engine gathers its slices'
    rows there)."""

    def __init__(self, merge_fn, on_sync, every: int, fetch_fn=None):
        if every < 1:
            raise ValueError(f"stats_sync_every must be >= 1, got {every}")
        self._merge = merge_fn
        self._on_sync = on_sync
        self._every = every
        self._fetch = fetch_fn or (lambda x: x.cpu().numpy())
        self._acc = None
        self._rounds = 0

    def push(self, stats) -> None:
        self._acc = stats if self._acc is None else self._merge(self._acc, stats)
        self._rounds += 1
        if self._rounds >= self._every:
            self.flush()

    def flush(self) -> None:
        if self._acc is None:
            return
        st = self._fetch(self._acc)
        self._acc = None
        self._rounds = 0
        self._on_sync(st)


def partition_packed(batch: KVBatch, n_bins: int, bin_capacity: int,
                     bucket: torch.Tensor | None = None, leftover_capacity: int = 0,
                     payload: torch.Tensor | None = None, filled: bool = False):
    """Scatter a batch into ``[n_bins, bin_capacity]`` bins by key hash,
    packed as the all-to-all sends them.

    ``bucket`` overrides the destination (``[N]`` in ``[0, n_bins)``);
    by default it is ``fold_hash(lanes) % n_bins`` on the unsigned value.
    A bin keeps its rows' input order; live rows past their bin's
    capacity go to a compacted leftover buffer of ``leftover_capacity``
    rows (re-shuffled by the caller), and those that fit neither are
    counted in ``overflow``: true loss.  ``payload`` (``[N, W]``, with no
    leftover) travels beside the rows into the same slots.  One pass of
    ``ops/kernels/partition.stable_partition``: the kernel on a CUDA
    batch, its plain version on a CPU one.

    Returns ``(bins, overflow, leftover, binned)``: ``bins`` int32
    ``[B, C, L + 2]`` (lanes, value, a valid word), ``overflow`` an int32
    scalar tensor, ``leftover`` a ``KVBatch`` of ``leftover_capacity``
    rows, ``binned`` the payload's ``[B, C, W]`` or None.  With
    ``filled``, a fifth: int32 ``[B]``, each bin's filled slots
    (``min(total, C)``), which are its first.
    """
    lanes = batch.key_lanes
    if bucket is None:
        bucket = packing.fold_hash(lanes) % n_bins
    rows, overflow, binned, totals = stable_partition(
        bucket, batch.valid, lanes, batch.values, n_bins, bin_capacity, leftover_capacity,
        payload)
    n_lanes, flat = lanes.shape[1], n_bins * bin_capacity
    left = rows[flat:]
    out = (rows[:flat].reshape(n_bins, bin_capacity, n_lanes + 2), overflow,
           KVBatch(left[:, :n_lanes], left[:, n_lanes], left[:, n_lanes + 1] != 0), binned)
    return (*out, totals.clamp(max=bin_capacity)) if filled else out


def partition_to_bins(batch: KVBatch, n_bins: int, bin_capacity: int,
                      bucket: torch.Tensor | None = None, leftover_capacity: int = 0):
    """``partition_packed``'s bins in the JAX package's form: ``(lanes [B,
    C, L], values [B, C], valid [B, C], overflow, leftover)``, the lanes
    and values views of the packed bins."""
    bins, overflow, leftover, _ = partition_packed(batch, n_bins, bin_capacity, bucket,
                                                   leftover_capacity)
    n_lanes = bins.shape[-1] - 2
    return bins[..., :n_lanes], bins[..., n_lanes], bins[..., n_lanes + 1] != 0, overflow, leftover


def unpack_bins(bins: torch.Tensor) -> KVBatch:
    """``partition_packed``'s packed bins (or what arrived of them) as one
    batch, bin-major."""
    n_lanes = bins.shape[-1] - 2
    rows = bins.reshape(-1, n_lanes + 2)
    return KVBatch(rows[:, :n_lanes], rows[:, n_lanes], rows[:, n_lanes + 1] != 0)


def exchange_bins(mesh: Mesh, axis: str, bins: torch.Tensor) -> KVBatch:
    """One all-to-all of ``partition_packed``'s bins along ``axis``: bin
    ``i`` goes to the ``i``-th rank; returns what this rank received,
    sender-major."""
    return unpack_bins(mesh.all_to_all(bins, axis))


def merge_stats_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Across-round merge of ``[..., 6]`` stats stacks: overflows and
    drains add, distinct and backlog take the later round's, the worst
    shard's distinct the maximum."""
    a = a.reshape(-1, 6)
    b = b.reshape(-1, 6)
    return torch.stack(
        [a[:, 0] + b[:, 0], a[:, 1] + b[:, 1], b[:, 2], b[:, 3],
         torch.maximum(a[:, 4], b[:, 4]), a[:, 5] + b[:, 5]],
        dim=1,
    ).reshape(-1)


class ShuffleStep:
    """The per-rank feed-and-drain body shared by the flat and hierarchical
    engines (one copy, so the drain and stats protocol cannot diverge).

    ``shuffle_axis`` carries the all-to-all; ``stat_axis`` is the axis the
    backlog and stats reduce over: the shuffle axis itself, which for the
    hierarchical engine is the intra-slice axis, so nothing in a round
    crosses slices.  ``__call__(lines, acc, leftover)`` returns ``(acc,
    leftover, stats)``, stats ``[emit_ovf_sum, shuf_ovf_sum,
    distinct_sum, backlog, distinct_max, drains]`` (int32, on the device).

    ``fused_preagg``: kernel C pre-aggregates the shard's lines in one
    launch; its table and residual rows, padded to the block's emit
    count, are the local combine's output.  When the kernel's flag is set
    (a tile stranded more keys than its residual rows hold), the shard's
    lines go through the stock map and ``combine_or_passthrough`` instead;
    the overflow is the kernel's either way.  ``refolds`` counts those.
    """

    def __init__(self, cfg: EngineConfig, map_fn, combine: str, n_bins: int,
                 bin_capacity: int, shard_capacity: int, leftover_capacity: int,
                 max_drains: int, mesh: Mesh, shuffle_axis: str, stat_axis: str,
                 fused_preagg: bool = False):
        self.cfg, self.map_fn, self.combine = cfg, map_fn, combine
        self.n_bins, self.bin_capacity = n_bins, bin_capacity
        self.shard_capacity, self.leftover_capacity = shard_capacity, leftover_capacity
        self.max_drains, self.mesh = max_drains, mesh
        self.shuffle_axis, self.stat_axis = shuffle_axis, stat_axis
        self.fused_preagg = fused_preagg
        self.refolds = 0

    def _local_table(self, lines: torch.Tensor):
        """Map + local combine: same capacity contract on every path (as
        many rows as the block has emits); partition ignores order."""
        cfg, n_lanes = self.cfg, self.cfg.key_lanes
        if self.fused_preagg:
            from locust_tpu_torch.ops.kernels.fused_fold import fused_block_preagg

            ktab, kresid, emit_ovf, bad = fused_block_preagg(lines, cfg)
            if not bool(bad):  # one host read per round, as on one device
                pre = KVBatch.concat(ktab, kresid)
                cap = lines.shape[0] * cfg.emits_per_line
                return KVBatch.concat(
                    pre, KVBatch.empty(cap - pre.size, n_lanes, lines.device)), emit_ovf
            self.refolds += 1
            kv, _ = self.map_fn(lines, cfg)  # the same tokenizer overflow
            return combine_or_passthrough(
                kv, self.combine, probes=2, scatter_impl=scatter_impl_for(cfg.sort_mode)
            ), emit_ovf
        kv, emit_ovf = self.map_fn(lines, cfg)
        if cfg.sort_mode in HASHT_FAMILY:
            return combine_or_passthrough(
                kv, self.combine, probes=2, scatter_impl=scatter_impl_for(cfg.sort_mode)
            ), emit_ovf
        return reduce_into(kv, kv.size, self.combine, cfg.sort_mode)[0], emit_ovf

    def shuffle_round(self, table_in: KVBatch, acc: KVBatch, leftover: KVBatch, carry):
        """One partition + all-to-all + merge, shared by feed and drain.
        The backlog joins at the partition; a key both in the backlog and
        in new rows is sent twice and merges at its destination.  Returns
        ``(acc, leftover, local)``: ``local`` is ``carry`` (``[0, 0,
        shuffle overflow so far, map overflow]``) plus this rank's backlog,
        distinct count and this round's shuffle overflow."""
        bins, shuf_ovf, new_left, _ = partition_packed(
            KVBatch.concat(table_in, leftover), self.n_bins, self.bin_capacity,
            leftover_capacity=self.leftover_capacity,
        )
        received = exchange_bins(self.mesh, self.shuffle_axis, bins)
        new_acc, distinct = fold_into(acc, received, self.shard_capacity, self.combine,
                                      self.cfg.sort_mode)
        local = torch.stack([new_left.valid.sum(dtype=torch.int32), distinct.to(torch.int32),
                             shuf_ovf, torch.zeros_like(shuf_ovf)]) + carry
        return new_acc, new_left, local

    def __call__(self, lines: torch.Tensor, acc: KVBatch, leftover: KVBatch):
        local_table, emit_ovf = self._local_table(lines)
        dev = lines.device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        carry = torch.stack([zero, zero, zero, emit_ovf.to(torch.int32)])
        acc, leftover, local = self.shuffle_round(local_table, acc, leftover, carry)
        # One sum over the group per shuffle round: every rank reads the
        # same backlog and takes the same number of drain trips.
        summed = self.mesh.all_reduce(local, self.stat_axis)
        drains = 0
        zero_table = KVBatch.empty(local_table.size, self.cfg.key_lanes, dev)
        while int(summed[0]) > 0 and drains < self.max_drains:
            carry = torch.stack([zero, zero, local[2], local[3]])
            acc, leftover, local = self.shuffle_round(zero_table, acc, leftover, carry)
            summed = self.mesh.all_reduce(local, self.stat_axis)
            drains += 1
        worst = self.mesh.all_reduce(local[1:2], self.stat_axis, op="max")
        stats = torch.cat([summed[3:4], summed[2:3], summed[1:2], summed[0:1], worst,
                           torch.tensor([drains], dtype=torch.int32, device=dev)])
        return acc, leftover, stats


def _fused_mesh_gate(cfg: EngineConfig, map_fn, combine: str, engine: str,
                     device) -> tuple[bool, bool]:
    """``(kernel_on, demoted)`` for ``sort_mode="fused"`` on a mesh engine;
    a demotion is logged once, at construction."""
    if cfg.sort_mode != "fused":
        return False, False
    from locust_tpu_torch.ops.kernels.fused_fold import fused_mesh_eligible

    ok, why = fused_mesh_eligible(cfg, map_fn, combine, device)
    if not ok:
        logger.info(
            "%s mesh sort_mode='fused': kernel not engaged — %s "
            "(results carry fused_demoted=True)", engine, why,
        )
    return ok, not ok


class DistributedMapReduce:
    """Mesh-parallel MapReduce: each rank maps its lines, shuffles by key
    hash and carries its hash shard of the table across rounds.

    Processes the corpus in rounds of ``n_devices * cfg.block_lines``
    lines; consistent hash partitioning keeps each rank's merge local.
    """

    def __init__(self, mesh: Mesh, cfg: EngineConfig, axis_name: str = DATA_AXIS,
                 map_fn=wordcount_map, combine: str = "sum", skew_factor: float = 2.0,
                 on_overflow: str = "retry", shard_capacity: int | None = None,
                 bin_capacity: int | None = None):
        if on_overflow not in ("retry", "drop"):
            raise ValueError(f"on_overflow must be 'retry' or 'drop', got {on_overflow!r}")
        self.mesh = mesh
        self.cfg = cfg
        self.axis = axis_name
        self.map_fn = map_fn
        self.combine = combine
        self.on_overflow = on_overflow
        self.n_dev = mesh.shape[axis_name]
        # The all-to-all moves FULL bins; the default fits emits_per_block
        # distinct keys a rank.  A smaller bin costs drain rounds, never data.
        if bin_capacity is not None and bin_capacity < 1:
            raise ValueError(f"bin_capacity must be >= 1, got {bin_capacity}")
        self.bin_capacity = (
            _round_up(int(bin_capacity), 8)
            if bin_capacity is not None
            else sized_bins(cfg.emits_per_block, self.n_dev, skew_factor)
        )
        # Table rows per rank: one round's receive volume, or the rank's
        # share of cfg.resolved_table_size, whichever is larger.
        self.shard_capacity = (
            shard_capacity
            if shard_capacity is not None
            else max(self.n_dev * self.bin_capacity,
                     sized_bins(cfg.resolved_table_size, self.n_dev, skew_factor))
        )
        if self.shard_capacity < 1:
            raise ValueError(f"shard_capacity must be >= 1, got {self.shard_capacity}")
        self.leftover_capacity = cfg.emits_per_block if on_overflow == "retry" else 0
        self.max_drain_rounds = 2 + -(-cfg.emits_per_block // self.bin_capacity)
        # "count" lowers to emit-1 + sum; checkpoints name the lowered map.
        norm_map_fn, norm_combine = normalize_combine(map_fn, combine)
        self._norm_map_name = getattr(norm_map_fn, "__name__", str(norm_map_fn))
        self._fused_kernel_on, self.fused_demoted = _fused_mesh_gate(
            cfg, map_fn, combine, "flat", mesh.device)
        self._step = ShuffleStep(
            cfg, norm_map_fn, norm_combine, n_bins=self.n_dev,
            bin_capacity=self.bin_capacity, shard_capacity=self.shard_capacity,
            leftover_capacity=self.leftover_capacity, max_drains=self.max_drain_rounds,
            mesh=mesh, shuffle_axis=axis_name, stat_axis=axis_name,
            fused_preagg=self._fused_kernel_on,
        )

    # ------------------------------------------------------------------ api

    @property
    def lines_per_round(self) -> int:
        return self.n_dev * self.cfg.block_lines

    def empty_table(self) -> KVBatch:
        """This rank's empty shard of the accumulator."""
        return KVBatch.empty(self.shard_capacity, self.cfg.key_lanes, self.mesh.device)

    def empty_leftover(self) -> KVBatch:
        """This rank's empty shuffle backlog (0 rows in drop mode)."""
        return KVBatch.empty(self.leftover_capacity, self.cfg.key_lanes, self.mesh.device)

    def _identity(self) -> dict:
        """Engine, pipeline and mesh identity bound into every checkpoint
        fingerprint; equal to the JAX engine's for the same configuration."""
        return dict(
            engine="flat",
            cfg=repr(self.cfg),
            combine=self.combine,
            map_fn=self._norm_map_name,
            mesh=f"{self.n_dev}x{self.axis}",
            bin_capacity=self.bin_capacity,
            shard_capacity=self.shard_capacity,
            on_overflow=self.on_overflow,
        )

    def _fingerprint(self, rows) -> str:
        from locust_tpu_torch.io.serde import fingerprint_corpus

        return fingerprint_corpus(rows, **self._identity())

    def run(self, rows, checkpoint_dir: str | None = None,
            checkpoint_every: int = 1, stats_sync_every: int = 16) -> "DistributedResult":
        """Run the full corpus; ``rows`` is the host ``[n, line_width]``
        array, the same on every rank.  In "retry" mode each feed round
        drains its backlog in extra all-to-all rounds (at most
        ``max_drain_rounds``), so bin overflow never loses data.  With
        ``checkpoint_dir``, every ``checkpoint_every`` rounds the gathered
        table, backlog and counters land in one npz per process, and a
        re-run with the same fingerprint resumes after the last one."""
        lpr = self.lines_per_round
        nrounds = max(1, -(-rows.shape[0] // lpr))
        chunks = (rows[r * lpr:(r + 1) * lpr] for r in range(nrounds))
        return self._run_rounds(
            chunks,
            fingerprint=self._fingerprint(rows) if checkpoint_dir is not None else None,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, stats_sync_every=stats_sync_every,
        )

    def run_stream(self, blocks, fingerprint: str | None = None,
                   checkpoint_dir: str | None = None, checkpoint_every: int = 1,
                   stats_sync_every: int = 16) -> "DistributedResult":
        """``run`` over an iterable of ``[<= lines_per_round, width]`` host
        blocks (e.g. ``StreamingCorpus(path, width, lines_per_round)``);
        pass its ``fingerprint()`` to checkpoint."""
        from locust_tpu_torch.io.loader import prefetch_blocks

        return self._run_rounds(
            prefetch_blocks(blocks),
            fingerprint=stream_checkpoint_fingerprint(fingerprint, checkpoint_dir,
                                                      self._identity()),
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, stats_sync_every=stats_sync_every,
        )

    def _run_rounds(self, chunk_iter, fingerprint, checkpoint_dir,
                    checkpoint_every: int, stats_sync_every: int) -> "DistributedResult":
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        if stats_sync_every < 1:
            raise ValueError(f"stats_sync_every must be >= 1, got {stats_sync_every}")
        lpr, width = self.lines_per_round, self.cfg.line_width
        acc, leftover = self.empty_table(), self.empty_leftover()
        counters = dict(emit_ovf=0, shuf_ovf=0, distinct=0, drains_used=0, truncated=False)
        start_round = 0
        self._step.refolds = 0

        ckpt = None
        if checkpoint_dir is not None:
            ckpt = ShardedCheckpoint(checkpoint_dir, fingerprint, self.mesh,
                                     async_writes=self.cfg.async_checkpoint)
            restored = ckpt.load()
            if restored is not None:
                start_round, extras, acc, leftover = restored
                for k in ("emit_ovf", "shuf_ovf", "distinct", "drains_used"):
                    counters[k] = int(extras[k])
                counters["truncated"] = bool(extras["truncated"])

        def snapshot(next_round: int) -> None:
            ckpt.snapshot(
                next_round, acc, leftover,
                emit_ovf=np.int64(counters["emit_ovf"]),
                shuf_ovf=np.int64(counters["shuf_ovf"]),
                distinct=np.int64(counters["distinct"]),
                drains_used=np.int64(counters["drains_used"]),
                truncated=np.bool_(counters["truncated"]),
            )

        def on_sync(st) -> None:
            """Fold the synced stats into the host counters; police the
            no-loss invariants (loudly, if a few rounds late)."""
            counters["emit_ovf"] += int(st[0])
            counters["shuf_ovf"] += int(st[1])
            counters["distinct"] = int(st[2])
            backlog = int(st[3])
            counters["truncated"] |= int(st[4]) > self.shard_capacity
            counters["drains_used"] += int(st[5])
            if backlog > 0:
                raise RuntimeError(
                    f"shuffle backlog failed to drain in {self.max_drain_rounds} rounds "
                    f"({backlog} entries remain); raise skew_factor")
            if counters["shuf_ovf"] and self.on_overflow == "retry":
                raise RuntimeError(
                    f"shuffle lost {counters['shuf_ovf']} entries despite retry mode; "
                    "map_fn emitted more than cfg.emits_per_block live rows")

        round_stats = RoundStats(merge_stats_vectors, on_sync, stats_sync_every)

        def fold_round(chunk) -> None:
            nonlocal acc, leftover
            chunk = normalize_round_chunk(chunk, lpr, width)
            acc, leftover, stats = self._step(shard_rows(chunk, self.mesh), acc, leftover)
            round_stats.push(stats)

        drive_checkpointed_rounds(chunk_iter, fold_round, round_stats, ckpt, snapshot,
                                  checkpoint_every, start_round)
        if counters["truncated"]:
            logger.warning(
                "a shard's distinct keys exceeded its table capacity (%d); "
                "tail keys dropped — raise shard_capacity", self.shard_capacity)
        return DistributedResult(
            table=acc, emit_overflow=counters["emit_ovf"], shuffle_overflow=counters["shuf_ovf"],
            distinct=counters["distinct"], combine=self.combine,
            drain_rounds=counters["drains_used"], truncated=counters["truncated"],
            fused_kernel="mesh" if self._fused_kernel_on else None,
            fused_demoted=self.fused_demoted, mesh=self.mesh, axis=None,
            fused_refolds=getattr(self._step, "refolds", 0),
        )


class DistributedResult:
    """A mesh run's result: this rank's shard of the table (``table``) and
    the run's counters, the same on every rank.  ``gather`` collects every
    shard (along ``axis``; the whole world when None) onto every rank."""

    def __init__(self, table: KVBatch, emit_overflow: int, shuffle_overflow: int,
                 distinct: int, combine: str = "sum", drain_rounds: int = 0,
                 truncated: bool = False, fused_kernel: str | None = None,
                 fused_demoted: bool = False, mesh: Mesh | None = None,
                 axis: str | None = None, fused_refolds: int = 0):
        self.table = table
        self.emit_overflow = emit_overflow        # tokens beyond the per-line cap
        self.shuffle_overflow = shuffle_overflow  # entries LOST in the shuffle
        self.distinct = distinct
        self.combine = combine
        self.drain_rounds = drain_rounds          # extra all-to-all rounds used
        self.truncated = truncated                # a shard's table overflowed
        # "mesh" when kernel C served each shard's local combine;
        # fused_demoted when "fused" was asked for and the run folded as
        # plain "hasht" (a CPU rank, an ineligible shape).
        self.fused_kernel = fused_kernel
        self.fused_demoted = fused_demoted
        self.fused_refolds = fused_refolds        # this rank's flagged re-folds
        self.mesh = mesh
        self.axis = axis

    def gather(self) -> dict:
        """Every shard's table in the JAX package's numpy form (uint32
        lanes, int32 values, bool valid), on every rank."""
        return _batch_to_host(self.table, self.mesh, self.axis)

    def to_host_pairs(self, sort: bool = True) -> list[tuple[bytes, int]]:
        """Gather every shard and decode it; with ``sort``, in global key
        order (the shards are hash partitions).  Every rank returns the
        same full table."""
        from locust_tpu_torch.engine import finalize_host_pairs
        from locust_tpu_torch.state import table_from_jax

        full = self.gather()
        return finalize_host_pairs(
            table_from_jax(full["key_lanes"], full["values"], full["valid"], "cpu"),
            self.combine, sort)
