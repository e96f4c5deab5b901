"""Fold-level reduce dispatch.

Port of the sort branch of ``locust_tpu/ops/hash_table.py:532-603``
(``reduce_into`` / ``fold_into``): sort + segment reduce, where one sort
of ``concat(acc, batch)`` both groups the new rows and merges them into
the running table.  The sort-free hasht family raises
``NotImplementedError`` until slice 2 (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch

from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.ops.process_stage import require_mode, sort_and_compact
from locust_tpu_torch.ops.reduce_stage import segment_reduce_into


def reduce_into(
    batch: KVBatch, out_size: int, combine: str, sort_mode: str
) -> tuple[KVBatch, torch.Tensor]:
    """Reduce ``batch`` into a bounded ``out_size`` table; returns
    ``(table, num_segments)``."""
    require_mode(sort_mode)
    return segment_reduce_into(sort_and_compact(batch, sort_mode), out_size, combine)


def fold_into(
    acc: KVBatch, batch: KVBatch, out_size: int, combine: str, sort_mode: str
) -> tuple[KVBatch, torch.Tensor]:
    """Fold NEW rows into an existing bounded table produced by an earlier
    fold at the same ``(out_size, combine, sort_mode)``."""
    return reduce_into(KVBatch.concat(acc, batch), out_size, combine, sort_mode)
