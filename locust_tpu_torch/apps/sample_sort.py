"""Distributed sample sort: TeraSort-style global ordering over the mesh.

Port of ``locust_tpu/apps/sample_sort.py`` onto ``torch.distributed``,
one rank per process (``locust_tpu_torch.parallel``).  A global sort of
(key, value) records across every rank, by the classic sample-sort
recipe:

  1. SAMPLE    every rank takes a strided sample of its valid keys; one
               ``all_gather`` shares all samples; every rank sorts the
               (small) sample set identically and picks n_dev-1 splitters.
  2. PARTITION bucket = #splitters <= key (``core/packing.lanes_geq_table``,
               the lexicographic compare on packed lanes); scatter into
               equal-capacity bins; the range shuffle hands each rank its
               bin's filled prefix (``Mesh.all_to_all_v``, after one small
               all-to-all of the counts), so what arrives is dense.
  3. LOCAL SORT each rank sorts what it received by its full key lanes
               (``ops/process_stage`` "lex" mode: exact byte order).

Rank d then holds range shard d, internally sorted, and every key on rank
d precedes every key on rank d+1: a globally sorted sequence.
``sort_records`` sorts whole fixed-width records by a key prefix (the
TeraSort record sort): the partition writes the record bytes into the
bins beside their keys, one more all-to-all moves them, and they are
gathered into key order after the local sort.  A bin holds at most a
rank's own rows, so it is capped there.  Skewed
inputs (duplicate-heavy keys) can overflow a range bin; the overflow is
counted and summed over the ranks (an integer, exact in any order), and
``sort_strings`` retries with doubled bins.  The sorts are stable torch
sorts; the JAX package's are not, so rows of equal keys may carry their
values in another order (the keys, the overflow and the retries are the
same).

Spans ``sample_sort.sample`` (the splitters), ``sample_sort.partition``
(the buckets and the bins, then the decode of what arrived),
``sample_sort.exchange`` (the counts' all-to-all and read, the keys' and
the records' all-to-all), ``sample_sort.local`` (the lex sort) and
``sample_sort.records`` (the records' gather into key order); counters
``sample_sort.rows`` (valid rows this rank sorted),
``sample_sort.retries`` (``sort_strings``' doublings),
``sample_sort.host_syncs`` (host reads of the sort's tensors) and
``sample_sort.slots_skipped`` (the empty bin slots a rank did not
send); the mesh counts the exchange's bytes (``mesh.all_to_all_bytes``).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from locust_tpu_torch import obs
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.core import bytes_ops, packing
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.ops.process_stage import _lexsort, sort_and_compact
from locust_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, scatter_host_array, shard_rows
from locust_tpu_torch.parallel.shuffle import (
    gather_batch_host,
    partition_packed,
    sized_bins,
    unpack_bins,
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _host_ints(*ts: torch.Tensor) -> list[int]:
    """The tensors' elements on the host, in order, in one read, counted
    in ``sample_sort.host_syncs``."""
    obs.metric_inc("sample_sort.host_syncs")
    return [int(v) for v in torch.cat([t.reshape(-1).to(torch.int64) for t in ts]).tolist()]


def _record_words(records: torch.Tensor) -> torch.Tensor:
    """``[n, R]`` uint8 records as ``[n, R / k]`` rows of the widest
    integer of ``k`` bytes that divides ``R`` (the same memory): fewer,
    wider elements for the gathers that move whole records."""
    width = records.shape[1]
    for dtype in (torch.int64, torch.int32, torch.int16):
        if width % dtype.itemsize == 0:
            return records.contiguous().view(dtype)
    return records.contiguous()


class DistributedSort:
    """Globally sort fixed-width byte keys (with int32 payloads) on a mesh."""

    def __init__(self, mesh: Mesh, cfg: EngineConfig, rows_per_device: int,
                 axis_name: str = DATA_AXIS, sample_per_device: int = 64,
                 skew_factor: float = 2.0):
        self.mesh = mesh
        self.cfg = cfg
        self.axis = axis_name
        self.n_dev = mesh.shape[axis_name]
        self.rows_per_device = rows_per_device
        self.sample_per_device = sample_per_device
        # A bin never receives more than the rank's own rows.
        self.bin_capacity = min(sized_bins(rows_per_device, self.n_dev, skew_factor),
                                _round_up(max(1, rows_per_device), 8))
        self.shard_capacity = self.n_dev * self.bin_capacity

    def _splitters(self, lanes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """The ``n_dev - 1`` splitters, the same on every rank.  Valid rows
        are sampled first (padding would drag the splitters to zero), at
        a stride over the valid prefix (a rank's contiguous line range is
        often clustered, so a prefix sample would skew the bins)."""
        n_dev, s = self.n_dev, self.sample_per_device
        dev = lanes.device
        compact_idx = torch.sort((~valid).to(torch.int8), stable=True).indices
        n_valid, = _host_ints(valid.sum())
        i = torch.arange(s, device=dev)
        stride_idx = i * (n_valid // s) + (i * (n_valid % s)) // s
        take = compact_idx[stride_idx.clamp(0, lanes.shape[0] - 1)]
        all_samples = self.mesh.all_gather(lanes[take], self.axis)          # [n_dev*s, L]
        all_ok = self.mesh.all_gather(valid[take].to(torch.uint8), self.axis) != 0
        # Invalid samples last, then the n_dev-1 splitters at quantiles of
        # the valid prefix only.
        u = packing.to_u32(all_samples)
        sorted_lanes = all_samples[_lexsort([(~all_ok).to(torch.int64), *u.unbind(dim=1)])]
        n_valid_samples, = _host_ints(all_ok.sum())
        j = torch.arange(1, n_dev, device=dev)
        idx = (j * n_valid_samples // n_dev).clamp(0, sorted_lanes.shape[0] - 1)
        return sorted_lanes[idx]

    def _exchange(self, bins: torch.Tensor, binned: torch.Tensor | None,
                  filled: torch.Tensor):
        """The range shuffle of each bin's filled prefix: the counts first
        (one small all-to-all, then this rank's send and receive counts in
        one read), then the keys' and the records' rows alone.  Returns
        what arrived, dense and sender-major: the packed rows and the
        records (or None)."""
        n = self.n_dev
        sizes = _host_ints(filled, self.mesh.all_to_all(filled, self.axis))
        send, recv = sizes[:n], sizes[n:]
        obs.metric_inc("sample_sort.slots_skipped", n * self.bin_capacity - sum(send))
        arrived = self.mesh.all_to_all_v([bins[b, :c] for b, c in enumerate(send)], recv,
                                         self.axis)
        moved = None if binned is None else self.mesh.all_to_all_v(
            [binned[b, :c] for b, c in enumerate(send)], recv, self.axis)
        return arrived, moved

    def _step(self, keys_rows: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
              records: torch.Tensor | None = None):
        """This rank's body: sample, range shuffle, local sort.  Returns
        its sorted shard, the overflow summed over the ranks and, given
        ``records`` (one row for each of the batch's), the rows this rank
        received, sender-major, which the shard's values then index.  On
        more than one rank only the bins' filled prefixes travel, so the
        shard holds the rows that arrived, every one valid; on one the bins
        are what arrives, empty slots and all."""
        kv = KVBatch.from_bytes(keys_rows, values, valid)
        shuffle = self.n_dev > 1
        with obs.span("sample_sort.sample"):
            splitters = self._splitters(kv.key_lanes, valid)
        with obs.span("sample_sort.partition"):
            bucket = packing.lanes_geq_table(kv.key_lanes, splitters).sum(dim=-1)  # [N] in [0, n)
            # ``filled``: the bins' filled counts, on more than one rank only.
            bins, overflow, _, binned, *filled = partition_packed(
                kv, self.n_dev, self.bin_capacity, bucket=bucket, payload=records,
                filled=shuffle)
        with obs.span("sample_sort.exchange"):
            arrived, moved = self._exchange(bins, binned, *filled) if shuffle else (bins, binned)
        # The sent bins are dead once their all-to-all returned (on one rank
        # they are what arrived, and stay).
        del bins, binned
        # The decode of what arrived is the bins' work, not the exchange's.
        with obs.span("sample_sort.partition"):
            received = unpack_bins(arrived)
            if moved is not None:
                moved = moved.reshape(-1, moved.shape[-1])
                received = KVBatch(received.key_lanes, torch.arange(
                    received.size, dtype=torch.int32, device=moved.device), received.valid)
        with obs.span("sample_sort.local"):
            table = sort_and_compact(received, mode="lex")
        return table, self.mesh.all_reduce(overflow, self.axis), moved

    def sort_rows(self, keys: np.ndarray, values: np.ndarray | None = None) -> "SortResult":
        """Globally sort host ``[n, key_width]`` byte rows (+ optional
        values), the same on every rank.  n must be <= n_dev *
        rows_per_device; shorter inputs are padded with invalid rows."""
        total = self.n_dev * self.rows_per_device
        n = keys.shape[0]
        if n > total:
            raise ValueError(f"{n} rows > capacity {total}; raise rows_per_device")
        if values is None:
            values = np.arange(n, dtype=np.int32)  # original index payload
        pk = np.zeros((total, self.cfg.key_width), np.uint8)
        pk[:n] = keys[:, : self.cfg.key_width]
        pv = np.zeros((total,), np.int32)
        pv[:n] = values
        pvalid = np.zeros((total,), bool)
        pvalid[:n] = True
        mine = n - self.mesh.rank * self.rows_per_device
        obs.metric_inc("sample_sort.rows", min(max(mine, 0), self.rows_per_device))
        table, overflow, _ = self._step(shard_rows(pk, self.mesh),
                                        scatter_host_array(pv, self.mesh),
                                        scatter_host_array(pvalid, self.mesh))
        overflow, = _host_ints(overflow)
        # The host gather takes shard_capacity rows a rank: pad what arrived.
        pad = self.shard_capacity - table.size
        if pad:
            table = KVBatch.concat(table, KVBatch.empty(pad, table.key_lanes.shape[1],
                                                        table.key_lanes.device))
        return SortResult(table, overflow, self.shard_capacity, self.mesh, self.axis)

    def sort_records(self, records, key_bytes: int) -> tuple[torch.Tensor, int]:
        """Globally sort this rank's ``[n, R]`` uint8 records (a tensor on
        the rank's device; numpy is copied there once) by their first
        ``key_bytes`` bytes, unsigned, zero-padded to ``cfg.key_width``.
        ``n`` may differ between ranks, up to ``rows_per_device``.

        Returns this rank's sorted records ``[m, R]`` on its device and
        the overflow summed over the ranks: rank ``d`` holds range ``d``,
        so the ranks' outputs in rank order are the global order.  Stable:
        equal keys keep their input order (sender-major across ranks)."""
        dev = self.mesh.device
        records = torch.as_tensor(records, device=dev)
        if records.dim() != 2 or records.dtype != torch.uint8:
            raise ValueError(f"records must be [n, R] uint8, got {tuple(records.shape)} "
                             f"{records.dtype}")
        n, width = records.shape
        if not 0 < key_bytes <= min(self.cfg.key_width, width):
            raise ValueError(f"key_bytes {key_bytes} must lie in [1, min(key_width "
                             f"{self.cfg.key_width}, record width {width})]")
        if max(n, self.rows_per_device) >= 2**31:
            raise ValueError(f"{max(n, self.rows_per_device)} rows: the sort's int32 row "
                             "indices hold fewer than 2**31")
        if n > self.rows_per_device:
            raise ValueError(f"{n} records > rows_per_device {self.rows_per_device}")
        obs.metric_inc("sample_sort.rows", n)
        # The partition takes each row's record beside it, so the batch has
        # the records' rows; an empty rank sorts one invalid row.
        rows = max(n, 1)
        keys = torch.zeros((rows, self.cfg.key_width), dtype=torch.uint8, device=dev)
        keys[:n, :key_bytes] = records[:, :key_bytes]
        index = torch.arange(rows, dtype=torch.int32, device=dev)
        words = _record_words(records if n else records.new_zeros((1, width)))
        table, overflow, received = self._step(keys, index, index < n, words)
        overflow, m = _host_ints(overflow, table.num_valid())
        with obs.span("sample_sort.records"):
            out = received[table.values[:m].long()]
        return out.view(torch.uint8), overflow


class SortResult:
    """A sort's result: this rank's sorted range shard (``table``) and the
    overflow summed over the ranks."""

    def __init__(self, table: KVBatch, overflow: int, shard_capacity: int, mesh: Mesh,
                 axis: str = DATA_AXIS):
        self.table = table
        self.overflow = overflow
        self.shard_capacity = shard_capacity
        self.mesh = mesh
        self.axis = axis

    def to_host_sorted(self) -> list[tuple[bytes, int]]:
        """Every rank's sorted valid prefix, gathered and concatenated in
        rank order: the global order, on every rank.

        Warns loudly if rows were dropped (overflowed range bins): the
        result is then NOT a permutation of the input; re-sort with a
        higher skew_factor (``sort_strings`` does this itself)."""
        if self.overflow:
            logging.getLogger("locust_tpu_torch").warning(
                "sample sort dropped %d rows (range-bin overflow); "
                "output is truncated — raise skew_factor",
                self.overflow,
            )
        full = gather_batch_host(self.table, self.mesh, self.axis)
        n_shards = full.size // self.shard_capacity
        out: list[tuple[bytes, int]] = []
        for d in range(n_shards):
            lo, hi = d * self.shard_capacity, (d + 1) * self.shard_capacity
            out.extend(KVBatch(full.key_lanes[lo:hi], full.values[lo:hi],
                               full.valid[lo:hi]).to_host_pairs())
        return out


def sort_strings(strings: list[bytes], mesh: Mesh, cfg: EngineConfig | None = None,
                 max_retries: int | None = None, **kw) -> list[bytes]:
    """Convenience: globally sort byte strings, truncated to key_width.

    Lossless: if a skewed or duplicate-heavy distribution overflows a
    range bin, the sort is retried with DOUBLED skew_factor (bigger
    bins).  The default budget doubles until ``skew_factor >= n_dev``,
    where one bin holds a whole rank's shard and overflow is impossible,
    so the default path cannot fail on any input that fits the mesh.  An
    explicit ``max_retries`` caps the doublings instead, raising
    ``ValueError`` rather than returning a silently truncated list."""
    cfg = cfg or EngineConfig()
    n_dev = mesh.shape[DATA_AXIS]
    rows_per_device = _round_up(max(1, -(-len(strings) // n_dev)), 8)
    rows = bytes_ops.strings_to_rows(strings, cfg.key_width)
    skew = kw.pop("skew_factor", 2.0)
    if max_retries is None:
        max_retries = max(1, math.ceil(math.log2(max(2.0, n_dev / skew))) + 1)
    for attempt in range(max_retries + 1):
        if attempt:
            obs.metric_inc("sample_sort.retries")
        ds = DistributedSort(mesh, cfg, rows_per_device, skew_factor=skew, **kw)
        res = ds.sort_rows(rows)
        if res.overflow == 0:
            return [k for k, _ in res.to_host_sorted()]
        skew *= 2.0
    raise ValueError(
        f"sample sort still dropped {res.overflow} rows at "
        f"skew_factor={skew / 2}; input too skewed for this mesh"
    )
