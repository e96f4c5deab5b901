"""The MapReduce engine: pluggable map/combine over blocked byte tensors.

Port of the single-device engine of ``locust_tpu/engine.py``.  The corpus
streams through fixed-shape blocks of ``cfg.block_lines`` lines; each
block's emits are concatenated with the bounded running table
(``cfg.resolved_table_size`` rows) and folded into it: in the sort modes
ONE sort + segment reduce both groups the new emits and merges them into
the table; in the hasht family the hash-table fold does it without a
sort (ops/hash_table.py).  Under ``sort_mode="fused"`` the fused kernel
(ops/kernels/fused_fold.py) first pre-aggregates the block, and the
hasht fold settles its table and residual rows.  ``run`` /
``run_fused`` fold block after block; ``timed_run`` runs Map, Process,
Reduce and the table merge as separate, synchronised stages for the
reference's per-stage report (main.cu:405-468).  ``run_batch`` folds a
stack of independent jobs.  ``run_stream`` folds an iterable of host
blocks in bounded memory (a staging ring, at most
``STREAM_DISPATCH_DEPTH`` folds in flight, snapshots on a background
writer); under ``fused`` it stages segments of blocks and folds each with
ONE fused-kernel launch.  ``run_checkpointed`` folds host rows with
crash-resumable snapshots and, given a ``backend.CircuitBreaker``, fails
a fold over to the CPU and back.  Python loops stand in for the JAX package's
``jit`` and ``lax.scan``: PyTorch runs eagerly and the device queue keeps
the blocks' launches back to back.

The engine runs on CUDA unless the caller asks for the CPU
(``device="cpu"``); with no GPU and no explicit CPU it raises.  It emits
the JAX engine's telemetry (``obs``; off unless enabled, e.g. by
``EngineConfig(trace=True)``): the ``engine.stage.*`` spans of
``timed_run``, and ``stream.block``, ``stream.stall`` and ``ckpt.mark``
with their metrics in ``run_stream`` and ``run_checkpointed``.  The port
adds spans inside the fold: ``engine.stage_blocks`` (``prepare_blocks``;
in ``run_stream`` each block's pad into the staging ring),
``engine.fold.block`` (one block of ``run``, ``run_blocks``,
``run_batch``), ``engine.fold.map`` (``fold_block``; the sort and reduce
spans are ``ops/hash_table.py``'s) and ``engine.fold.drain`` (each fold
runner's final wait for the card), and the ``engine.host_syncs`` counter:
every host read of a fold's tensors and every explicit wait, counted on
any device so the CPU's count is the card's.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from locust_tpu_torch import backend as backend_mod
from locust_tpu_torch import obs
from locust_tpu_torch.config import (
    DEFAULT_CONFIG,
    HASHT_FAMILY,
    EngineConfig,
    fused_stream_seg_blocks,
)
from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.io.loader import prefetch_blocks
from locust_tpu_torch.io.snapshot import AsyncCheckpointWriter
from locust_tpu_torch.ops.hash_table import fold_into
from locust_tpu_torch.ops.kernels.fused_fold import (
    fused_block_preagg,
    fused_engine_eligible,
)
from locust_tpu_torch.ops.map_stage import wordcount_map
from locust_tpu_torch.ops.process_stage import sort_and_compact
from locust_tpu_torch.ops.reduce_stage import (
    normalize_combine,
    segment_reduce,
    segment_reduce_into,
)
from locust_tpu_torch.state import load_jax_checkpoint, save_snapshot
from locust_tpu_torch.utils.checks import validate_batch

logger = logging.getLogger("locust_tpu_torch")

MapFn = Callable[[torch.Tensor, EngineConfig], tuple[KVBatch, torch.Tensor]]

# Host-side monoid mirrors of ops/reduce_stage.COMBINERS, used to re-merge
# duplicate table rows (distinct keys sharing a folded sort key).
_HOST_COMBINE = {
    "sum": lambda a, b: a + b,
    "count": lambda a, b: a + b,
    "min": min,
    "max": max,
}


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for and absent: the
    port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --backend cpu) "
            "to run on the CPU"
        )
    return dev


def finalize_host_pairs(
    table: KVBatch, combine: str = "sum", sort: bool = True
) -> list[tuple[bytes, int]]:
    """Decode a device table to host (key, value) pairs, exactly:
    re-merges duplicate key rows and restores lexicographic key order."""
    op = _HOST_COMBINE[combine]
    merged: dict[bytes, int] = {}
    for k, v in table.to_host_pairs():
        merged[k] = op(merged[k], v) if k in merged else v
    pairs = list(merged.items())
    return sorted(pairs) if sort else pairs


def _wrap_i32(v: int) -> int:
    """Two's-complement int32 wraparound, the device table's value dtype."""
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def merge_host_pairs(
    base: list[tuple[bytes, int]],
    delta: list[tuple[bytes, int]],
    combine: str = "sum",
) -> list[tuple[bytes, int]]:
    """Merge two finalized host-pairs lists by key; sum/count wrap in
    int32 as the device accumulator does."""
    op = _HOST_COMBINE[combine]
    wrap = combine in ("sum", "count")
    merged: dict[bytes, int] = dict(base)
    for k, v in delta:
        if k in merged:
            out = op(merged[k], v)
            merged[k] = _wrap_i32(int(out)) if wrap else out
        else:
            merged[k] = v
    return sorted(merged.items())


@dataclasses.dataclass
class StageTimes:
    """Per-stage wall-clock, the reference's timing report (main.cu:405-468)."""

    map_ms: float = 0.0
    process_ms: float = 0.0
    reduce_ms: float = 0.0

    @property
    def total_ms(self) -> float:
        return self.map_ms + self.process_ms + self.reduce_ms


@dataclasses.dataclass
class RunResult:
    table: KVBatch            # unique keys + combined values (device order)
    num_segments: int         # distinct keys found (<= table capacity)
    overflow_tokens: int      # emits dropped by the per-line cap
    truncated: bool           # True if distinct keys exceeded table capacity
    times: StageTimes
    combine: str = "sum"
    # run_stream only: blocks folded, staging, backpressure stall and
    # checkpoint-writer stats, with the JAX engine's keys.
    stream: dict | None = None
    # Which fused-kernel formulation ran: "batch" per block (set as the
    # JAX engine sets it, timed_run included), "stream" one launch per
    # run_stream segment, None no kernel.
    fused_kernel: str | None = None
    # True when sort_mode="fused" was asked for but the kernel is not
    # eligible (fused_engine_eligible): the fold ran exactly like hasht.
    fused_demoted: bool = False
    # Blocks (or run_stream segments) whose kernel flag sent them
    # through the stock re-fold.
    fused_refolds: int = 0

    def to_host_pairs(self, sort: bool = True) -> list[tuple[bytes, int]]:
        """Decode the table, re-merge duplicate rows, sort by key."""
        return finalize_host_pairs(self.table, self.combine, sort)

    def dump_intermediate(self, path: str, fmt: str = "tsv") -> None:
        """Stage-1 output: the table's host pairs as an intermediate file,
        ``tsv`` or ``bin`` (io/serde.py)."""
        from locust_tpu_torch.io import serde

        serde.write_intermediate(self.to_host_pairs(), path, fmt)


def normalize_block(chunk, block_lines: int, width: int, out: np.ndarray | None = None) -> np.ndarray:
    """Validate one host block and zero-pad it to ``[block_lines, width]``
    uint8 (the JAX package's ``normalize_round_chunk``).  Rows wider than
    ``width`` or more than ``block_lines`` rows are the caller's error.
    With ``out`` (a ``[block_lines, width]`` uint8 buffer) the block is
    copied in, the rest zeroed, and ``out`` returned."""
    chunk = np.asarray(chunk, dtype=np.uint8)
    if chunk.ndim != 2:
        raise ValueError(f"round chunk must be 2-D, got shape {chunk.shape}")
    if chunk.shape[1] > width:
        raise ValueError(
            f"round chunk rows are {chunk.shape[1]} bytes wide but "
            f"cfg.line_width={width}; ingest with the same width"
        )
    if chunk.shape[0] > block_lines:
        raise ValueError(
            f"round chunk has {chunk.shape[0]} rows, more than its round "
            f"capacity of {block_lines} (engine block_lines); size stream "
            "blocks to match"
        )
    if out is None:
        out = np.zeros((block_lines, width), np.uint8)
    n, w = chunk.shape
    out[:n, :w] = chunk
    out[n:, :] = 0
    out[:n, w:] = 0
    return out


class _StagingRing:
    """Reusable host staging buffers for ``run_stream``: ``slots``
    ``[rows, width]`` uint8 tensors, page-locked for a CUDA device so the
    copy to the card runs asynchronously, handed out round-robin.

    A slot must not be refilled while its copy may still read it.
    ``run_stream`` records a CUDA event after every fold (it follows the
    fold's copy as well as its kernels) and waits on the event of the fold
    ``STREAM_DISPATCH_DEPTH`` back before staging the next one; with
    ``STREAM_DISPATCH_DEPTH + 1`` slots, the slot refilled for fold ``i``
    last fed fold ``i - slots``, whose event has been waited on.  On the
    CPU every fold has finished when it returns."""

    def __init__(self, slots: int, rows: int, width: int, pin: bool):
        self._bufs = [torch.zeros((rows, width), dtype=torch.uint8, pin_memory=pin)
                      for _ in range(slots)]
        self._next = 0

    def next(self) -> torch.Tensor:
        buf = self._bufs[self._next]
        self._next = (self._next + 1) % len(self._bufs)
        return buf


class _CheckpointPump:
    """Per-run snapshot scheduler.  Synchronous mode writes in the fold
    loop; async mode (``cfg.async_checkpoint``) marks a generation, a
    device copy of the table taken on the fold's stream, and hands the
    write to the bounded background writer (io/snapshot.py), latest wins.
    The writer waits on an event recorded after the copy before its
    ``.cpu()``, whatever stream the writer thread sees as current.  The
    snapshot is the same either way (state.save_snapshot)."""

    def __init__(self, engine: "MapReduceEngine", state_path: str, fingerprint: str,
                 use_async: bool):
        self._eng = engine
        self._path = state_path
        self._fp = fingerprint
        self._writer = AsyncCheckpointWriter() if use_async else None
        self.mark_ms = 0.0
        self._sync_writes = 0

    def mark(self, acc: KVBatch, next_block: int, overflow, max_distinct) -> None:
        t0 = time.perf_counter()
        obs.event(
            "ckpt.mark",
            generation=next_block,
            mode="async" if self._writer is not None else "sync",
        )
        obs.metric_inc("ckpt.marks")
        if self._writer is None:
            save_snapshot(self._path, acc, next_block, overflow, max_distinct, self._fp)
            self._sync_writes += 1
        else:
            # The counters are new tensors every fold: references do.
            snap = KVBatch(acc.key_lanes.clone(), acc.values.clone(), acc.valid.clone())
            self._writer.submit(next_block, functools.partial(
                _write_marked, self._eng._fence(acc.values.device), self._path, snap, next_block,
                overflow, max_distinct, self._fp))
        self.mark_ms += (time.perf_counter() - t0) * 1e3

    def finish(self) -> float:
        """Wait until the last marked generation is published (re-raising
        a writer error); returns the wait in ms."""
        t0 = time.perf_counter()
        if self._writer is not None:
            self._writer.flush()
        return (time.perf_counter() - t0) * 1e3

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()

    def stats(self) -> dict:
        out = {
            "mode": "async" if self._writer is not None else "sync",
            "mark_ms": round(self.mark_ms, 3),
        }
        if self._writer is not None:
            out.update(self._writer.stats())
        else:
            out["written"] = self._sync_writes
        return out


def _write_marked(ready, path, acc, next_block, overflow, max_distinct, fingerprint) -> None:
    """The writer thread's job: wait for the marked copy, then save it."""
    if ready is not None:
        ready.synchronize()
    save_snapshot(path, acc, next_block, overflow, max_distinct, fingerprint)


# A card whose half-open probes keep failing ends a breaker run: after
# the trip, at most this many probes, each after a full cooldown.
BREAKER_PROBES = 3


def _await_probe(breaker, device: torch.device, err: BaseException) -> None:
    """After a failed dispatch: a closed breaker retries at once; an open
    one is slept out until it admits its half-open probe.  The fold never
    leaves ``device``.  Raises, naming ``err``, once the card has failed
    its trip and ``BREAKER_PROBES`` probes in a row, or when the breaker
    stays open past its cooldown (another caller holds the probe)."""
    failed = breaker.stats()["consecutive_failures"]
    if failed >= breaker.threshold + BREAKER_PROBES:
        raise RuntimeError(
            f"dispatch on {device} failed {failed} times in a row, {BREAKER_PROBES} of them "
            f"half-open probes after the breaker's cooldown; the last: "
            f"{type(err).__name__}: {err}") from err
    deadline = time.monotonic() + breaker.cooldown_s + 1.0
    while not breaker.allow():
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"the breaker stayed open past its {breaker.cooldown_s} s cooldown after a "
                f"failed dispatch on {device}: {type(err).__name__}: {err}") from err
        time.sleep(min(breaker.cooldown_s, 0.05))


def _settle(device: torch.device) -> None:
    """Wait for the work queued on ``device`` after a failed dispatch; an
    error it reports belongs to that dispatch, which already counts as
    failed."""
    if device.type != "cuda":
        return
    try:
        torch.cuda.synchronize(device)  # locust: noqa[R003] once per failed dispatch in the breaker's retry loop: the error the queued work reports belongs to that dispatch
    except RuntimeError as e:
        logger.warning("synchronize after the failed dispatch raised: %s", e)


class MapReduceEngine:
    """Blocked map/process/reduce on one device."""

    # run_stream keeps at most this many folds in flight before it waits:
    # pipeline overlap without memory that grows with the corpus.
    STREAM_DISPATCH_DEPTH = 4

    def __init__(
        self,
        cfg: EngineConfig = DEFAULT_CONFIG,
        map_fn: MapFn = wordcount_map,
        combine: str = "sum",
        device=None,
    ):
        self.cfg = cfg
        if cfg.trace:
            # API-level telemetry opt-in (the CLI's --trace-out does the
            # same enable + an export at exit); idempotent, shares one
            # process timeline with any tracer already enabled.
            obs.enable()
        self.device = resolve_device(device)
        self.combine = combine  # user-facing semantics (host finalize)
        # "count" lowers to emit-1 + sum so the table merge is associative.
        self.map_fn, self._combine = normalize_combine(map_fn, combine)
        self._table_size = cfg.resolved_table_size
        # sort_mode="fused": the fused kernel replaces the map and the
        # block's first aggregation when its static checks pass (on the
        # RAW map_fn: the count wrapper emits the 1s the kernel counts);
        # otherwise the fold is exactly "hasht", logged once here.
        self._fused_kernel_on = False
        self._fused_demoted = False
        self._refolds = 0
        # Blocks per run_stream segment, each folded by ONE kernel launch
        # (the JAX package's fold_segment); 1 folds block by block.
        self._fused_stream_seg = 1
        if cfg.sort_mode == "fused":
            ok, why = fused_engine_eligible(cfg, map_fn, combine)
            self._fused_kernel_on, self._fused_demoted = ok, not ok
            if not ok:
                logger.info("sort_mode='fused': kernel not engaged — %s", why)
            else:
                self._fused_stream_seg = fused_stream_seg_blocks(
                    cfg.emits_per_block, cfg.block_lines, self.device.type == "cuda"
                )

    # ---------------------------------------------------------------- stages

    def fold_block(self, acc: KVBatch, lines: torch.Tensor):
        """Map one block (or a ``run_stream`` segment of blocks: any whole
        number of kernel tiles) and merge its emits into the running
        table.  Returns ``(table, overflow, distinct)``; ``distinct`` is
        counted before the capacity slice, so a truncation is observable.

        With the fused kernel on, the kernel pre-aggregates the block and
        the hasht fold settles ``concat(table, residual)`` into ``acc``:
        the same keys and totals as the block's emits, so the same table
        as "hasht" (fused_fold.py's contract).  When the kernel's flag is
        set, the block is re-folded through the stock path instead, as
        the JAX engine's ``lax.cond`` does; reading the flag is one host
        sync per block.  The overflow is the kernel's either way."""
        with obs.span("engine.fold.map"):
            if self._fused_kernel_on:
                ktab, kresid, overflow, flag = fused_block_preagg(lines, self.cfg)
                obs.metric_inc("engine.host_syncs")
                if bool(flag):  # locust: noqa[R003] one flag read per block or segment under fused: JAX's lax.cond (engine.py:402, 460) is a host branch here
                    self._refolds += 1
                    kv, _ = self.map_fn(lines, self.cfg)
                else:
                    kv = KVBatch.concat(ktab, kresid)
            else:
                kv, overflow = self.map_fn(lines, self.cfg)
        merged, distinct = fold_into(
            acc, kv, self._table_size, self._combine, self.cfg.sort_mode
        )
        return merged, overflow, distinct

    def _sync(self) -> None:
        obs.metric_inc("engine.host_syncs")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # locust: noqa[R003] stage-timing boundary of timed_run (JAX engine.py:669-681): the sync IS the measurement

    @staticmethod
    def _read_counters(*counters) -> list[int]:
        """The fold's device counters read on the host: a sync each on the
        card, counted in ``engine.host_syncs`` on any device."""
        obs.metric_inc("engine.host_syncs", len(counters))
        return [int(c) for c in counters]

    def _fence(self, device: torch.device | None = None) -> torch.cuda.Event | None:
        """A CUDA event recorded on the current stream of ``device`` (the
        engine's by default) after the work queued so far; None on the
        CPU, where that work is done."""
        device = self.device if device is None else device
        if device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        return ev

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """Copy a host block to the engine's device, asynchronously from
        page-locked memory."""
        return host.to(self.device, non_blocking=host.is_pinned())

    def empty_table(self) -> KVBatch:
        return KVBatch.empty(self._table_size, self.cfg.key_lanes, self.device)

    # ---------------------------------------------------------------- ingest

    def rows_from_lines(self, lines: Sequence[bytes]) -> np.ndarray:
        return bytes_ops.strings_to_rows(list(lines), self.cfg.line_width)

    def _host_blocks(self, rows: np.ndarray):
        """Yield fixed-shape [block_lines, line_width] host blocks,
        zero-padded (at least one block, as in the JAX engine)."""
        bl = self.cfg.block_lines
        for i in range(0, max(rows.shape[0], 1), bl):
            yield normalize_block(rows[i : i + bl], bl, rows.shape[1])

    def _blocks(self, rows: np.ndarray):
        """``_host_blocks``, each copied to the device."""
        for blk in self._host_blocks(rows):
            yield torch.from_numpy(blk).to(self.device)

    # ------------------------------------------------------------------- run

    def _fold_all(self, blocks, acc: KVBatch | None):
        """Fold every block into ``acc`` (an empty table when None); the
        counters stay on the device until the caller reads them."""
        acc = self.empty_table() if acc is None else acc
        self._refolds = 0
        overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        max_distinct = torch.zeros((), dtype=torch.int32, device=self.device)
        for i, blk in enumerate(blocks):
            with obs.span("engine.fold.block", i=i):
                acc, blk_overflow, distinct = self.fold_block(acc, blk)
                overflow = overflow + blk_overflow
                max_distinct = torch.maximum(max_distinct, distinct)
        return acc, max_distinct, overflow

    def run(self, rows: np.ndarray, acc: KVBatch | None = None) -> RunResult:
        """Per-block fold over host rows, each block copied to the device
        as it is folded.  ``acc`` continues from an earlier table (for
        example one folded by the JAX package, state.table_from_jax)."""
        t0 = time.perf_counter()
        acc, num, overflow = self._fold_all(self._blocks(rows), acc)
        with obs.span("engine.fold.drain"):
            self._sync()
        total_ms = (time.perf_counter() - t0) * 1e3
        num, overflow = self._read_counters(num, overflow)
        return self._finish(acc, num, overflow, StageTimes(0, total_ms, 0), self._refolds)

    def prepare_blocks(self, rows: np.ndarray) -> torch.Tensor:
        """Pad + reshape host rows into device-resident
        ``[nblocks, block_lines, line_width]`` blocks, one copy."""
        bl, w = self.cfg.block_lines, self.cfg.line_width
        n = rows.shape[0]
        nblocks = max(1, -(-n // bl))
        with obs.span("engine.stage_blocks"):
            padded = np.zeros((nblocks * bl, w), dtype=np.uint8)
            padded[:n] = rows[:, :w]
            return torch.from_numpy(padded.reshape(nblocks, bl, w)).to(self.device)

    def run_blocks(self, blocks: torch.Tensor, acc: KVBatch | None = None) -> RunResult:
        """Run over pre-staged ``[nblocks, block_lines, width]`` blocks."""
        t0 = time.perf_counter()
        acc, num, overflow = self._fold_all(blocks, acc)
        with obs.span("engine.fold.drain"):
            num, overflow = self._read_counters(num, overflow)  # every fold is done
        total_ms = (time.perf_counter() - t0) * 1e3
        return self._finish(acc, num, overflow, StageTimes(0, total_ms, 0), self._refolds)

    def run_fused(self, rows: np.ndarray) -> RunResult:
        """Whole-corpus run over blocks staged to the device in one copy."""
        return self.run_blocks(self.prepare_blocks(rows))

    def run_batch(self, blocks) -> list[RunResult]:
        """Fold a job-batched ``[njobs, nblocks, block_lines, width]`` stack
        (a tensor or array, copied to the device once): every job folds
        into its own table and counters, one RunResult per job, read with
        one host sync at the end.  Zero-filled jobs (batch padding) fold
        to empty tables.  ``times`` carries the whole batch's wall."""
        t0 = time.perf_counter()
        blocks = torch.as_tensor(blocks).to(self.device)
        folds = []
        for job in blocks:
            acc, num, overflow = self._fold_all(job, None)
            folds.append((acc, num, overflow, self._refolds))
        # One host sync: the whole batch is done.
        counters = [torch.stack([num, overflow]) for _, num, overflow, _ in folds]
        if counters:
            with obs.span("engine.fold.drain"):
                obs.metric_inc("engine.host_syncs")
                counters = torch.stack(counters).cpu().tolist()
        total_ms = (time.perf_counter() - t0) * 1e3
        return [
            self._finish(acc, num, overflow, StageTimes(0, total_ms, 0), refolds)
            for (acc, _, _, refolds), (num, overflow) in zip(folds, counters)
        ]

    def timed_run(self, rows: np.ndarray) -> RunResult:
        """Per-stage timing parity with the reference's report
        (main.cu:405-468): every stage ends in a device sync.  The
        cross-block table merge is a sort and counts to Process.  As in
        the JAX engine, the stages are the split map / sort / reduce for
        every mode, the hasht family grouping by "hashp1"."""
        cfg, mode = self.cfg, self.cfg.sort_mode
        acc = self.empty_table()
        overflow = 0
        max_distinct = torch.zeros((), dtype=torch.int32, device=self.device)
        times = StageTimes()
        for blk in self._blocks(rows):
            # The obs spans shadow the t0..t4 boundaries (each stage's
            # sync is inside its span), so an exported timeline and the
            # StageTimes report agree.
            t0 = time.perf_counter()
            with obs.span("engine.stage.map"):
                kv, blk_overflow = self.map_fn(blk, cfg)
                self._sync()
            t1 = time.perf_counter()
            with obs.span("engine.stage.process"):
                kv = sort_and_compact(kv, mode)
                self._sync()
            t2 = time.perf_counter()
            with obs.span("engine.stage.reduce"):
                table = segment_reduce(kv, self._combine)
                self._sync()
            t3 = time.perf_counter()
            with obs.span("engine.stage.merge"):
                acc, distinct = segment_reduce_into(
                    sort_and_compact(KVBatch.concat(acc, table), mode),
                    self._table_size,
                    self._combine,
                )
                max_distinct = torch.maximum(max_distinct, distinct)
                self._sync()
            t4 = time.perf_counter()
            times.map_ms += (t1 - t0) * 1e3
            times.process_ms += (t2 - t1) * 1e3 + (t4 - t3) * 1e3
            times.reduce_ms += (t3 - t2) * 1e3
            overflow += self._read_counters(blk_overflow)[0]
        return self._finish(acc, self._read_counters(max_distinct)[0], overflow, times)

    def run_lines(self, lines: Sequence[bytes]) -> RunResult:
        return self.run(self.rows_from_lines(lines))

    # ------------------------------------------------------------- streaming

    def run_stream(
        self,
        blocks,
        checkpoint_dir: str | None = None,
        every: int = 8,
        fingerprint: str | None = None,
    ) -> RunResult:
        """Fold an iterable of ``[<=block_lines, width]`` host row blocks
        (e.g. ``io.loader.StreamingCorpus``) in bounded memory: a reader
        thread runs ahead (``prefetch_blocks``), blocks are zero-padded
        into a reusable staging ring, at most ``STREAM_DISPATCH_DEPTH``
        folds are in flight, and the counters stay on the device.

        With ``checkpoint_dir`` and a corpus ``fingerprint`` (e.g.
        ``StreamingCorpus.fingerprint()``), snapshots land every ``every``
        blocks as in ``run_checkpointed`` and a re-run resumes at the last
        one: it re-reads the folded blocks but does not fold them again.

        Under ``sort_mode="fused"`` with the kernel engaged, blocks are
        staged into segments of ``fused_stream_seg_blocks`` blocks and each
        segment is folded by ONE fused-kernel launch (the trailing partial
        segment zero-padded); a flagged segment is re-folded whole through
        the stock path.  ``RunResult.stream`` reports the run."""
        blocks = prefetch_blocks(blocks)  # overlap host reads with folds
        try:
            return self._run_stream(blocks, checkpoint_dir, every, fingerprint)
        finally:
            blocks.close()  # stops the reader thread, also on an exception

    def _run_stream(self, blocks, checkpoint_dir, every, fingerprint) -> RunResult:
        cfg = self.cfg
        bl, w = cfg.block_lines, cfg.line_width
        acc = self.empty_table()
        overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        max_distinct = torch.zeros((), dtype=torch.int32, device=self.device)
        start_block = 0
        pump = None
        if checkpoint_dir is not None:
            if every < 1:
                raise ValueError(f"checkpoint every must be >= 1, got {every}")
            if fingerprint is None:
                raise ValueError(
                    "run_stream needs an explicit corpus fingerprint to "
                    "checkpoint (e.g. StreamingCorpus.fingerprint())"
                )
            fingerprint = f"{fingerprint}:{cfg!r}:{self.combine}:" + getattr(
                self.map_fn, "__name__", str(self.map_fn)
            )
            os.makedirs(checkpoint_dir, exist_ok=True)
            state_path = os.path.join(checkpoint_dir, "state.npz")
            start_block, overflow, max_distinct, acc = self._load_state(
                state_path, fingerprint, acc, overflow, max_distinct
            )
            pump = _CheckpointPump(self, state_path, fingerprint, cfg.async_checkpoint)

        # Segments of `seg` blocks, one fold each: under the fused kernel
        # one launch per segment, else one block per fold.
        segmented = self._fused_kernel_on and self._fused_stream_seg > 1
        seg = self._fused_stream_seg if segmented else 1
        ring = (
            _StagingRing(self.STREAM_DISPATCH_DEPTH + 1, seg * bl, w,
                         pin=self.device.type == "cuda")
            if cfg.stream_staging_ring
            else None
        )
        self._refolds = 0
        inflight: collections.deque = collections.deque()
        stall_ms = flush_ms = 0.0
        segments = 0
        i = start_block - 1  # an empty iterator folds nothing, marks nothing
        last_mark = start_block
        fill = 0
        cur = None
        t0 = time.perf_counter()

        def dispatch(n_filled: int, end: int) -> None:
            nonlocal acc, overflow, max_distinct, segments, stall_ms, last_mark
            cur_np = cur.numpy()  # locust: noqa[R003] cur is the host staging buffer (CPU memory): .numpy() is a view, no device sync
            cur_np[n_filled * bl:] = 0  # a partial segment's missing blocks
            # The span covers the copy and the fold's dispatch, not device
            # completion (that shows in the stream.stall events).
            span_args = {"seg_blocks": n_filled} if segmented else {}
            with obs.span("stream.block", i=end - 1,
                          staging="ring" if ring is not None else "alloc", **span_args):
                acc, seg_overflow, distinct = self.fold_block(acc, self._to_device(cur))
            overflow = overflow + seg_overflow
            max_distinct = torch.maximum(max_distinct, distinct)
            segments += 1
            inflight.append(self._fence())
            if len(inflight) > self.STREAM_DISPATCH_DEPTH:
                # Backpressure: wait on the fold DEPTH back, which also
                # frees its staging slot for reuse (_StagingRing).
                t_sync = time.perf_counter()
                ev = inflight.popleft()
                obs.metric_inc("engine.host_syncs")  # the wait, on any device
                if ev is not None:
                    ev.synchronize()  # locust: noqa[R003] bounded-inflight backpressure (JAX engine.py:806, 914): waits on the fold STREAM_DISPATCH_DEPTH back, which frees its staging slot
                sync_ms = (time.perf_counter() - t_sync) * 1e3
                stall_ms += sync_ms
                obs.event("stream.stall", block=end - 1, ms=round(sync_ms, 3))
                obs.metric_observe("stream.stall_ms", sync_ms)
            due = end - last_mark >= every if segmented else end % every == 0
            if pump is not None and due:
                pump.mark(acc, end, overflow, max_distinct)
                last_mark = end

        try:
            for i, blk in enumerate(blocks):
                if i < start_block:  # resume: re-read, don't re-fold
                    continue
                with obs.span("engine.stage_blocks"):
                    if fill == 0:
                        cur = ring.next() if ring is not None else torch.zeros((seg * bl, w), dtype=torch.uint8)
                    normalize_block(blk, bl, w, out=cur.numpy()[fill * bl:(fill + 1) * bl])  # locust: noqa[R003] cur is the host staging buffer (CPU memory): .numpy() is a view, no device sync
                fill += 1
                if fill == seg:
                    dispatch(fill, i + 1)
                    fill = 0
            if fill:
                dispatch(fill, i + 1)
            # The final generation, unless the cadence just wrote it.
            if pump is not None and i + 1 > last_mark:
                pump.mark(acc, i + 1, overflow, max_distinct)
            if pump is not None:
                flush_ms = pump.finish()  # durable before returning
        finally:
            if pump is not None:
                pump.close()
        with obs.span("engine.fold.drain"):
            self._sync()
        total_ms = (time.perf_counter() - t0) * 1e3
        num, overflow = self._read_counters(max_distinct, overflow)
        obs.metric_inc("stream.blocks", max(0, i + 1 - start_block))
        stream = {
            "blocks": max(0, i + 1 - start_block),
            "staging_ring": ring is not None,
            "donate_fold": cfg.donate_fold,
            "backpressure_stall_ms": round(stall_ms, 3),
            "total_ms": round(total_ms, 3),
        }
        if segmented:
            stream["fused"] = {
                "formulation": "stream",
                "seg_blocks": seg,
                "segments": segments,
                "interpret": self.device.type != "cuda",  # the plain version ran
            }
        if pump is not None:
            stream["ckpt"] = dict(pump.stats(), every=every, final_flush_ms=round(flush_ms, 3))
        return self._finish(
            acc, num, overflow, StageTimes(0, total_ms, 0), self._refolds,
            stream=stream, fused_kernel="stream" if segmented else None,
        )

    # ---------------------------------------------------------- checkpointing

    def _load_state(self, state_path: str, fingerprint: str, acc: KVBatch,
                    overflow: torch.Tensor, max_distinct: torch.Tensor, device=None):
        """Restore ``(start_block, overflow, max_distinct, acc)`` from a
        snapshot of the same run onto ``device`` (the engine's by
        default); otherwise pass the fresh state through.  A snapshot of
        another run, or one that cannot be read, starts the run afresh
        with a warning."""
        device = self.device if device is None else device
        if not os.path.exists(state_path):
            return 0, overflow, max_distinct, acc
        try:
            snap = load_jax_checkpoint(state_path, device)
        except Exception as e:  # noqa: BLE001 - a truncated or garbled npz
            logger.warning("checkpoint at %s is unreadable (%s: %s); starting fresh",
                           state_path, type(e).__name__, e)
            return 0, overflow, max_distinct, acc
        if snap.fingerprint != fingerprint:
            logger.warning("checkpoint at %s belongs to a different run; starting fresh",
                           state_path)
            return 0, overflow, max_distinct, acc
        logger.info("resuming from checkpoint at block %d (%s)", snap.next_block, state_path)

        def scalar(v: int) -> torch.Tensor:
            return torch.tensor(v, dtype=torch.int32, device=device)

        return snap.next_block, scalar(snap.overflow), scalar(snap.max_distinct), snap.acc

    def run_checkpointed(
        self,
        rows: np.ndarray,
        checkpoint_dir: str,
        every: int = 8,
        breaker=None,
    ) -> RunResult:
        """Block-granular fold with crash-resumable snapshots: every
        ``every`` blocks the table, the block cursor and the counters land
        in ONE atomically replaced npz, so a crash at any instant resumes
        without folding a block twice.  A re-run over other rows or with
        another configuration starts fresh.  The snapshot is the JAX
        engine's, field for field, so either package resumes the other's.

        ``breaker`` (a ``backend.CircuitBreaker``) opts in to retries:
        every fold runs through ``backend.guarded_dispatch`` (the
        ``backend.dispatch`` fault site).  A failed dispatch (an injected
        fault, a refused kernel launch, a CUDA error) reloads the last
        durable snapshot onto the engine's device and folds on from
        there: at once while the breaker is closed, after its cooldown
        once it is open (the first fold is the half-open probe).  The
        fold never leaves the engine's device: a card that fails
        ``BREAKER_PROBES`` probes in a row ends the run with an
        error naming the failure.  Any other error, and every failure
        without a breaker, raises."""
        from locust_tpu_torch.io.serde import fingerprint_corpus

        if every < 1:
            raise ValueError(f"checkpoint every must be >= 1, got {every}")
        os.makedirs(checkpoint_dir, exist_ok=True)
        state_path = os.path.join(checkpoint_dir, "state.npz")
        fingerprint = fingerprint_corpus(
            rows,
            cfg=repr(self.cfg),
            combine=self.combine,
            map_fn=getattr(self.map_fn, "__name__", str(self.map_fn)),
        )

        def load():
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            return self._load_state(
                state_path, fingerprint,
                KVBatch.empty(self._table_size, self.cfg.key_lanes, self.device), zero, zero,
                device=self.device,
            )

        start_block, overflow, max_distinct, acc = load()
        pump = _CheckpointPump(self, state_path, fingerprint, self.cfg.async_checkpoint)
        self._refolds = 0
        t0 = time.perf_counter()
        try:
            while True:
                dispatch_died = None
                i = start_block - 1
                last_mark = start_block
                for i, blk in enumerate(self._host_blocks(rows)):
                    if i < start_block:
                        continue
                    lines = torch.from_numpy(blk).to(self.device)
                    # Only the fold is retryable: a checkpoint writer's
                    # error re-raised by pump.mark stays loud.
                    if breaker is None:
                        acc, blk_overflow, distinct = self.fold_block(acc, lines)
                    else:
                        try:
                            acc, blk_overflow, distinct = backend_mod.guarded_dispatch(
                                breaker, functools.partial(self.fold_block, acc, lines),
                                block=i, backend="primary",
                            )
                        except backend_mod.DISPATCH_ERRORS as e:
                            dispatch_died = e
                            break
                    overflow = overflow + blk_overflow
                    max_distinct = torch.maximum(max_distinct, distinct)
                    if (i + 1) % every == 0:
                        pump.mark(acc, i + 1, overflow, max_distinct)
                        last_mark = i + 1
                if dispatch_died is None:
                    if i + 1 > last_mark:  # no second write of a cadence-aligned end
                        pump.mark(acc, i + 1, overflow, max_distinct)
                    pump.finish()  # the final generation is durable before returning
                    break
                # The dispatch died (guarded_dispatch counted it).  The
                # live table is suspect, the last snapshot is not: let
                # queued work settle, flush a pending write best effort,
                # wait until the breaker admits the card, and reload.
                logger.warning("fold of block %d failed on %s (%s: %s); reloading the last "
                               "checkpoint", i, self.device, type(dispatch_died).__name__,
                               dispatch_died)
                _settle(self.device)
                try:
                    pump.finish()
                except Exception as e:  # noqa: BLE001 - the reload decides
                    logger.warning("checkpoint flush after the failed dispatch failed (%s); "
                                   "resuming from the last durable generation", e)
                _await_probe(breaker, self.device, dispatch_died)
                start_block, overflow, max_distinct, acc = load()
        finally:
            pump.close()
        with obs.span("engine.fold.drain"):
            self._sync()
        total_ms = (time.perf_counter() - t0) * 1e3
        num, overflow = self._read_counters(max_distinct, overflow)
        return self._finish(acc, num, overflow, StageTimes(0, total_ms, 0), self._refolds)

    def _finish(self, acc, num_segments, overflow, times, refolds: int = 0,
                stream: dict | None = None, fused_kernel: str | None = None) -> RunResult:
        if os.environ.get("LOCUST_DEBUG_CHECKS"):
            # Opt-in invariant sweep of the result table: NUL-padded keys,
            # and the valid-prefix layout of the sort folds (the hasht
            # family's tables are slot-ordered, not compacted).
            validate_batch(acc, expect_compact=self.cfg.sort_mode not in HASHT_FAMILY)
        num = int(num_segments)
        truncated = num > acc.size
        if truncated:
            logger.warning(
                "distinct keys (%d) exceeded table capacity (%d); tail "
                "dropped — raise table_size (the default capacity is "
                "min(65536, max(one block's emits, 4096)))",
                num,
                acc.size,
            )
        if overflow and self.cfg.warn_on_overflow:
            logger.warning(
                "WARN: Exceeded emit limit — %d tokens beyond %d-per-line cap dropped",
                overflow,
                self.cfg.emits_per_line,
            )
        return RunResult(
            table=acc,
            num_segments=min(num, acc.size),
            overflow_tokens=overflow,
            truncated=truncated,
            times=times,
            combine=self.combine,
            stream=stream,
            fused_kernel=fused_kernel or ("batch" if self._fused_kernel_on else None),
            fused_demoted=self._fused_demoted,
            fused_refolds=refolds,
        )
