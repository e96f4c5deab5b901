"""The hierarchical two-level shuffle: a shuffle within each slice every
round, one combine across slices at the end.

Port of ``locust_tpu/parallel/hierarchical.py`` onto a ``[slice, data]``
world of processes (``parallel/mesh.make_mesh_2d``: rank ``s * D + d``;
the ``data`` group holds a slice's ranks, the ``slice`` group one data
index's ranks across slices).

* Each round every slice runs the flat engine's step (the same
  ``ShuffleStep``) with its all-to-all and its backlog and stats sums on
  the ``data`` group only: nothing in a round crosses slices, and each
  slice takes its own number of drain trips.  The stats vector differs
  between slices; at a sync the host gathers the slices' rows over the
  ``slice`` group and folds them.
* Once, at the end, each rank gathers its data index's table shards of
  every slice over the ``slice`` group (keys hash to the same data index
  in every slice, so the gather is shard-aligned) and merges them
  locally with ``reduce_into`` (kernel B under ``bitonic``).  Every slice
  then holds the same combined table; the result gathers it over the
  ``data`` group.
* Under ``LOCUST_DEBUG_CHECKS`` the combined tables and stats of all
  slices are gathered and compared before the result is returned
  (``_check_slice_replication``).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.ops.hash_table import reduce_into
from locust_tpu_torch.ops.map_stage import wordcount_map
from locust_tpu_torch.ops.reduce_stage import normalize_combine
from locust_tpu_torch.parallel.mesh import DATA_AXIS, SLICE_AXIS, Mesh, shard_rows
from locust_tpu_torch.parallel.shuffle import (
    DistributedResult,
    RoundStats,
    ShardedCheckpoint,
    ShuffleStep,
    _fused_mesh_gate,
    _round_up,
    drive_checkpointed_rounds,
    merge_stats_vectors,
    normalize_round_chunk,
    sized_bins,
    stream_checkpoint_fingerprint,
)

logger = logging.getLogger("locust_tpu_torch")


def _pack(table: KVBatch) -> torch.Tensor:
    """Lanes, value and valid of each row as one int32 ``[N, L + 2]``."""
    return torch.cat([table.key_lanes, table.values[:, None],
                      table.valid[:, None].to(torch.int32)], dim=1)


def _unpack(packed: torch.Tensor, n_lanes: int) -> KVBatch:
    return KVBatch(packed[:, :n_lanes].contiguous(), packed[:, n_lanes].contiguous(),
                   packed[:, n_lanes + 1] != 0)


class HierarchicalMapReduce:
    """Two-level mesh MapReduce on a ``[slice, data]`` world; ``run(rows)``
    returns a ``DistributedResult`` as the flat engine does."""

    def __init__(self, mesh: Mesh, cfg: EngineConfig, slice_axis: str = SLICE_AXIS,
                 data_axis: str = DATA_AXIS, map_fn=wordcount_map, combine: str = "sum",
                 skew_factor: float = 2.0, shard_capacity: int | None = None,
                 bin_capacity: int | None = None):
        if slice_axis not in mesh.shape or data_axis not in mesh.shape:
            raise ValueError(f"mesh must have axes ({slice_axis!r}, {data_axis!r}); "
                             f"got {tuple(mesh.shape)}")
        self.mesh = mesh
        self.cfg = cfg
        self.slice_axis = slice_axis
        self.data_axis = data_axis
        self.map_fn = map_fn
        self.combine = combine  # user semantics (host finalize)
        self.n_slices = int(mesh.shape[slice_axis])
        self.devs_per_slice = int(mesh.shape[data_axis])
        self.n_dev = self.n_slices * self.devs_per_slice
        if bin_capacity is not None and bin_capacity < 1:
            raise ValueError(f"bin_capacity must be >= 1, got {bin_capacity}")
        self.bin_capacity = (
            _round_up(int(bin_capacity), 8)
            if bin_capacity is not None
            else sized_bins(cfg.emits_per_block, self.devs_per_slice, skew_factor)
        )
        self.shard_capacity = (
            shard_capacity
            if shard_capacity is not None
            else max(self.devs_per_slice * self.bin_capacity,
                     sized_bins(cfg.resolved_table_size, self.devs_per_slice, skew_factor))
        )
        if self.shard_capacity < 1:
            raise ValueError(f"shard_capacity must be >= 1, got {self.shard_capacity}")
        self.leftover_capacity = cfg.emits_per_block
        self.max_drain_rounds = 2 + -(-cfg.emits_per_block // self.bin_capacity)
        norm_map_fn, self._norm_combine = normalize_combine(map_fn, combine)
        self._norm_map_name = getattr(norm_map_fn, "__name__", str(norm_map_fn))
        self._fused_kernel_on, self.fused_demoted = _fused_mesh_gate(
            cfg, map_fn, combine, "hierarchical", mesh.device)
        self._step = ShuffleStep(
            cfg, norm_map_fn, self._norm_combine, n_bins=self.devs_per_slice,
            bin_capacity=self.bin_capacity, shard_capacity=self.shard_capacity,
            leftover_capacity=self.leftover_capacity, max_drains=self.max_drain_rounds,
            mesh=mesh, shuffle_axis=data_axis, stat_axis=data_axis,
            fused_preagg=self._fused_kernel_on,
        )

    def _combine(self, acc: KVBatch):
        """The one cross-slice step: gather this data index's shard of
        every slice, merge locally.  Returns ``(table, [global distinct,
        worst shard's distinct])``, the same on every slice."""
        n_lanes = self.cfg.key_lanes
        gathered = _unpack(self.mesh.all_gather(_pack(acc), self.slice_axis), n_lanes)
        merged, distinct = reduce_into(gathered, self.shard_capacity, self._norm_combine,
                                       self.cfg.sort_mode)
        d = distinct.to(torch.int32).reshape(1)
        g_distinct = self.mesh.all_reduce(d, self.data_axis)
        worst = self.mesh.all_reduce(self.mesh.all_reduce(d, self.data_axis, op="max"),
                                     self.slice_axis, op="max")
        return merged, torch.cat([g_distinct, worst])

    def _combine_dbg(self, table: KVBatch, stats: torch.Tensor) -> dict:
        """Every slice's combined table and stats at this data index,
        gathered over the slice group: ``{name: [n_slices, ...] numpy}``."""
        gathered = self.mesh.all_gather(
            torch.cat([_pack(table).reshape(-1), stats.to(torch.int32)]), self.slice_axis
        ).reshape(self.n_slices, -1).cpu().numpy()
        n, width = table.size, self.cfg.key_lanes + 2
        rows = gathered[:, :n * width].reshape(self.n_slices, n, width)
        return {"key_lanes": rows[..., :-2], "values": rows[..., -2], "valid": rows[..., -1],
                "stats": gathered[:, n * width:]}

    def _check_slice_replication(self, table: KVBatch, stats: torch.Tensor) -> None:
        """The combined table must be the same on every slice: gather each
        slice's and compare them (``LOCUST_DEBUG_CHECKS``)."""
        for name, per_slice in self._combine_dbg(table, stats).items():
            bad = [s for s in range(1, self.n_slices)
                   if not np.array_equal(per_slice[s], per_slice[0])]
            if bad:
                raise RuntimeError(
                    "hierarchical combine produced a slice-varying "
                    f"'{name}' (slices {bad} differ from slice 0): a slice-varying "
                    "input leaked into the cross-slice merge")

    def _fetch_stats(self, stats: torch.Tensor) -> np.ndarray:
        """The slices' stats rows, ``[n_slices * 6]``, on every rank."""
        return self.mesh.all_gather(stats, self.slice_axis).cpu().numpy()

    # ------------------------------------------------------------------ api

    @property
    def lines_per_round(self) -> int:
        return self.n_dev * self.cfg.block_lines

    def _identity(self) -> dict:
        """The checkpoint fingerprint's identity, equal to the JAX engine's."""
        return dict(
            engine="hierarchical",
            cfg=repr(self.cfg),
            combine=self.combine,
            map_fn=self._norm_map_name,
            mesh=(f"{self.n_slices}x{self.slice_axis},"
                  f"{self.devs_per_slice}x{self.data_axis}"),
            bin_capacity=self.bin_capacity,
            shard_capacity=self.shard_capacity,
        )

    def _fingerprint(self, rows) -> str:
        from locust_tpu_torch.io.serde import fingerprint_corpus

        return fingerprint_corpus(rows, **self._identity())

    def run(self, rows, stats_sync_every: int = 16, checkpoint_dir: str | None = None,
            checkpoint_every: int = 1) -> DistributedResult:
        """Run a host ``[n, width]`` row array, the same on every rank.
        ``drain_rounds`` is the worst slice's total; ``truncated`` covers
        the slices' tables and the combined one."""
        lpr = self.lines_per_round
        nrounds = max(1, -(-rows.shape[0] // lpr))
        chunks = (rows[r * lpr:(r + 1) * lpr] for r in range(nrounds))
        return self._run_rounds(
            chunks, stats_sync_every,
            fingerprint=self._fingerprint(rows) if checkpoint_dir is not None else None,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)

    def run_stream(self, blocks, stats_sync_every: int = 16, fingerprint: str | None = None,
                   checkpoint_dir: str | None = None,
                   checkpoint_every: int = 1) -> DistributedResult:
        """``run`` over an iterable of ``[<= lines_per_round, width]`` host
        blocks; pass the stream's ``fingerprint()`` to checkpoint."""
        from locust_tpu_torch.io.loader import prefetch_blocks

        return self._run_rounds(
            prefetch_blocks(blocks), stats_sync_every,
            fingerprint=stream_checkpoint_fingerprint(fingerprint, checkpoint_dir,
                                                      self._identity()),
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)

    def _run_rounds(self, chunk_iter, stats_sync_every: int, fingerprint=None,
                    checkpoint_dir: str | None = None,
                    checkpoint_every: int = 1) -> DistributedResult:
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        cfg, dev = self.cfg, self.mesh.device
        lpr, width = self.lines_per_round, cfg.line_width
        acc = KVBatch.empty(self.shard_capacity, cfg.key_lanes, dev)
        leftover = KVBatch.empty(self.leftover_capacity, cfg.key_lanes, dev)
        counters = dict(emit_ovf=0, shuf_ovf=0, truncated=False)
        # Per-slice drain totals; the result reports the worst slice's.
        drains_by_slice = np.zeros(self.n_slices, np.int64)
        start_round = 0
        self._step.refolds = 0

        ckpt = None
        if checkpoint_dir is not None:
            ckpt = ShardedCheckpoint(checkpoint_dir, fingerprint, self.mesh,
                                     async_writes=cfg.async_checkpoint)
            restored = ckpt.load()
            if restored is not None:
                start_round, extras, acc, leftover = restored
                counters["emit_ovf"] = int(extras["emit_ovf"])
                counters["shuf_ovf"] = int(extras["shuf_ovf"])
                drains_by_slice[:] = extras["drains_by_slice"]
                counters["truncated"] = bool(extras["truncated"])

        def snapshot(next_round: int) -> None:
            ckpt.snapshot(
                next_round, acc, leftover,
                emit_ovf=np.int64(counters["emit_ovf"]),
                shuf_ovf=np.int64(counters["shuf_ovf"]),
                drains_by_slice=drains_by_slice.copy(),
                truncated=np.bool_(counters["truncated"]),
            )

        def on_sync(st) -> None:
            """Fold the ``[n_slices, 6]`` stats rows into host counters."""
            rows_ = np.asarray(st).reshape(self.n_slices, 6)
            counters["emit_ovf"] += int(rows_[:, 0].sum())
            counters["shuf_ovf"] += int(rows_[:, 1].sum())
            backlog = int(rows_[:, 3].sum())
            counters["truncated"] |= int(rows_[:, 4].max()) > self.shard_capacity
            drains_by_slice[:] += rows_[:, 5]
            if backlog > 0:
                raise RuntimeError(
                    f"shuffle backlog failed to drain in {self.max_drain_rounds} rounds "
                    f"({backlog} entries remain); raise skew_factor")
            if counters["shuf_ovf"]:
                raise RuntimeError(
                    f"shuffle lost {counters['shuf_ovf']} entries despite retry mode; "
                    "map_fn emitted more than cfg.emits_per_block live rows")

        round_stats = RoundStats(merge_stats_vectors, on_sync, stats_sync_every,
                                 fetch_fn=self._fetch_stats)

        def fold_round(chunk) -> None:
            nonlocal acc, leftover
            chunk = normalize_round_chunk(chunk, lpr, width)
            acc, leftover, stats = self._step(shard_rows(chunk, self.mesh), acc, leftover)
            round_stats.push(stats)

        drive_checkpointed_rounds(chunk_iter, fold_round, round_stats, ckpt, snapshot,
                                  checkpoint_every, start_round)
        table, cstats = self._combine(acc)
        if os.environ.get("LOCUST_DEBUG_CHECKS"):
            self._check_slice_replication(table, cstats)
        cstats = cstats.cpu().numpy()
        counters["truncated"] |= int(cstats[1]) > self.shard_capacity
        if counters["truncated"]:
            logger.warning(
                "a shard's distinct keys exceeded its table capacity (%d); "
                "tail keys dropped — raise shard_capacity", self.shard_capacity)
        return DistributedResult(
            table=table, emit_overflow=counters["emit_ovf"],
            shuffle_overflow=counters["shuf_ovf"], distinct=int(cstats[0]),
            combine=self.combine, drain_rounds=int(drains_by_slice.max()),
            truncated=counters["truncated"],
            fused_kernel="mesh" if self._fused_kernel_on else None,
            fused_demoted=self.fused_demoted, mesh=self.mesh, axis=self.data_axis,
            fused_refolds=self._step.refolds,
        )
