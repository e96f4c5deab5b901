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
reference's per-stage report (main.cu:405-468).  Python loops stand in
for the JAX package's ``jit`` and ``lax.scan``: PyTorch runs eagerly and
the device queue keeps the blocks' launches back to back.

The engine runs on CUDA unless the caller asks for the CPU
(``device="cpu"``); with no GPU and no explicit CPU it raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Sequence

import numpy as np
import torch

from locust_tpu_torch.config import DEFAULT_CONFIG, EngineConfig
from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.ops.hash_table import fold_into
from locust_tpu_torch.ops.kernels.fused_fold import (
    fused_block_preagg,
    fused_engine_eligible,
)
from locust_tpu_torch.ops.map_stage import wordcount_map
from locust_tpu_torch.ops.process_stage import require_mode, sort_and_compact
from locust_tpu_torch.ops.reduce_stage import (
    normalize_combine,
    segment_reduce,
    segment_reduce_into,
)

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
    # "batch" when sort_mode="fused" engaged the fused kernel (set as the
    # JAX engine sets it, timed_run included), else None.
    fused_kernel: str | None = None
    # True when sort_mode="fused" was asked for but the kernel is not
    # eligible (fused_engine_eligible): the fold ran exactly like hasht.
    fused_demoted: bool = False
    # Blocks whose kernel flag sent them through the stock re-fold.
    fused_refolds: int = 0

    def to_host_pairs(self, sort: bool = True) -> list[tuple[bytes, int]]:
        """Decode the table, re-merge duplicate rows, sort by key."""
        return finalize_host_pairs(self.table, self.combine, sort)


class MapReduceEngine:
    """Blocked map/process/reduce on one device."""

    def __init__(
        self,
        cfg: EngineConfig = DEFAULT_CONFIG,
        map_fn: MapFn = wordcount_map,
        combine: str = "sum",
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        require_mode(cfg.sort_mode)
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
        if cfg.sort_mode == "fused":
            ok, why = fused_engine_eligible(cfg, map_fn, combine)
            self._fused_kernel_on, self._fused_demoted = ok, not ok
            if not ok:
                logger.info("sort_mode='fused': kernel not engaged — %s", why)

    # ---------------------------------------------------------------- stages

    def fold_block(self, acc: KVBatch, lines: torch.Tensor):
        """Map one block and merge its emits into the running table.
        Returns ``(table, overflow, distinct)``; ``distinct`` is counted
        before the capacity slice, so a truncation is observable.

        With the fused kernel on, the kernel pre-aggregates the block and
        the hasht fold settles ``concat(table, residual)`` into ``acc``:
        the same keys and totals as the block's emits, so the same table
        as "hasht" (fused_fold.py's contract).  When the kernel's flag is
        set, the block is re-folded through the stock path instead, as
        the JAX engine's ``lax.cond`` does; reading the flag is one host
        sync per block.  The overflow is the kernel's either way."""
        if self._fused_kernel_on:
            ktab, kresid, overflow, flag = fused_block_preagg(lines, self.cfg)
            if bool(flag):
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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def empty_table(self) -> KVBatch:
        return KVBatch.empty(self._table_size, self.cfg.key_lanes, self.device)

    # ---------------------------------------------------------------- ingest

    def rows_from_lines(self, lines: Sequence[bytes]) -> np.ndarray:
        return bytes_ops.strings_to_rows(list(lines), self.cfg.line_width)

    def _blocks(self, rows: np.ndarray):
        """Yield fixed-shape [block_lines, line_width] device blocks,
        zero-padded (at least one block, as in the JAX engine)."""
        bl = self.cfg.block_lines
        n = rows.shape[0]
        for i in range(0, max(n, 1), bl):
            blk = rows[i : i + bl]
            if blk.shape[0] < bl:
                pad = np.zeros((bl - blk.shape[0], rows.shape[1]), np.uint8)
                blk = np.concatenate([blk, pad]) if blk.size else pad
            yield torch.from_numpy(np.ascontiguousarray(blk)).to(self.device)

    # ------------------------------------------------------------------- run

    def _fold_all(self, blocks, acc: KVBatch | None):
        """Fold every block into ``acc`` (an empty table when None); the
        counters stay on the device until the caller reads them."""
        acc = self.empty_table() if acc is None else acc
        self._refolds = 0
        overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        max_distinct = torch.zeros((), dtype=torch.int32, device=self.device)
        for blk in blocks:
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
        self._sync()
        total_ms = (time.perf_counter() - t0) * 1e3
        return self._finish(acc, num, int(overflow), StageTimes(0, total_ms, 0),
                            self._refolds)

    def prepare_blocks(self, rows: np.ndarray) -> torch.Tensor:
        """Pad + reshape host rows into device-resident
        ``[nblocks, block_lines, line_width]`` blocks, one copy."""
        bl, w = self.cfg.block_lines, self.cfg.line_width
        n = rows.shape[0]
        nblocks = max(1, -(-n // bl))
        padded = np.zeros((nblocks * bl, w), dtype=np.uint8)
        padded[:n] = rows[:, :w]
        return torch.from_numpy(padded.reshape(nblocks, bl, w)).to(self.device)

    def run_blocks(self, blocks: torch.Tensor, acc: KVBatch | None = None) -> RunResult:
        """Run over pre-staged ``[nblocks, block_lines, width]`` blocks."""
        t0 = time.perf_counter()
        acc, num, overflow = self._fold_all(blocks, acc)
        num = int(num)  # host sync: every fold is done
        total_ms = (time.perf_counter() - t0) * 1e3
        return self._finish(acc, num, int(overflow), StageTimes(0, total_ms, 0),
                            self._refolds)

    def run_fused(self, rows: np.ndarray) -> RunResult:
        """Whole-corpus run over blocks staged to the device in one copy."""
        return self.run_blocks(self.prepare_blocks(rows))

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
            t0 = time.perf_counter()
            kv, blk_overflow = self.map_fn(blk, cfg)
            self._sync()
            t1 = time.perf_counter()
            kv = sort_and_compact(kv, mode)
            self._sync()
            t2 = time.perf_counter()
            table = segment_reduce(kv, self._combine)
            self._sync()
            t3 = time.perf_counter()
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
            overflow += int(blk_overflow)
        return self._finish(acc, max_distinct, overflow, times)

    def run_lines(self, lines: Sequence[bytes]) -> RunResult:
        return self.run(self.rows_from_lines(lines))

    def _finish(self, acc, num_segments, overflow, times, refolds: int = 0) -> RunResult:
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
            fused_kernel="batch" if self._fused_kernel_on else None,
            fused_demoted=self._fused_demoted,
            fused_refolds=refolds,
        )
