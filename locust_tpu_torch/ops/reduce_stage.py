"""Reduce stage: segment boundaries + segment combine.

Port of ``locust_tpu/ops/reduce_stage.py:37-138``: on a key-grouped
batch (valid rows first, ops/process_stage.py),

    boundary_i  = valid_i & (i == 0 | key_i != key_{i-1})
    segment_ids = cumsum(boundary) - 1
    combined    = segment_combine(values, segment_ids)

with segments past ``out_size`` and invalid rows folded into one dump
slot.  Counts and ids stay int32 and value sums wrap in int32, as in the
JAX package.  The combines are ``index_add_`` / ``scatter_reduce_``,
which use atomics on CUDA: exact for integers in any order.
"""

from __future__ import annotations

import torch

from locust_tpu_torch.core.kv import KVBatch

COMBINERS = ("sum", "min", "max", "count")

_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)


def normalize_combine(map_fn, combine: str):
    """Lower "count" to emit-1 + "sum" so that folding partial tables stays
    associative; identity for the other combiners.  Returns
    ``(map_fn', combine')``."""
    if combine != "count":
        return map_fn, combine

    def count_map(lines, cfg, _base=map_fn):
        kv, overflow = _base(lines, cfg)
        return (
            KVBatch(
                key_lanes=kv.key_lanes,
                values=torch.ones_like(kv.values),
                valid=kv.valid,
            ),
            overflow,
        )

    count_map.__name__ = f"count_of_{getattr(map_fn, '__name__', 'map_fn')}"
    return count_map, "sum"


def _segment(values, ids, size, reduce: str) -> torch.Tensor:
    """``size``-slot segment combine of int32 ``values`` by ``ids``."""
    if reduce == "sum":
        out = torch.zeros(size, dtype=torch.int32, device=values.device)
        return out.index_add_(0, ids, values)
    fill = _I32_MAX if reduce == "amin" else _I32_MIN
    out = torch.full((size,), fill, dtype=torch.int32, device=values.device)
    return out.scatter_reduce_(0, ids, values, reduce=reduce, include_self=True)


def segment_reduce_into(
    batch: KVBatch, out_size: int, combine: str = "sum", out: KVBatch | None = None
) -> tuple[KVBatch, torch.Tensor]:
    """Segment-combine a key-grouped batch into a compact ``out_size``
    table.  Returns ``(table, num_segments)``; ``num_segments`` is the TRUE
    distinct-key count (int32 scalar), which may exceed ``out_size``.

    With ``out`` (an ``out_size``-row table that ``batch`` does not
    alias), the table is written into ``out``'s tensors and ``out`` is
    returned: the fold graph (fold_graph.py) chains its table so."""
    if combine not in COMBINERS:
        raise ValueError(f"combine must be one of {COMBINERS}, got {combine!r}")
    lanes, values, valid = batch.key_lanes, batch.values, batch.valid
    n = lanes.shape[0]
    dev = lanes.device

    prev = torch.roll(lanes, 1, dims=0)
    neq = (lanes != prev).any(dim=-1)
    first = torch.arange(n, device=dev) == 0
    boundary = valid & (first | neq)
    seg = torch.cumsum(boundary.to(torch.int32), dim=0, dtype=torch.int32) - 1
    num_segments = boundary.sum(dtype=torch.int32)
    ids = torch.where(valid, torch.clamp(seg, max=out_size), out_size).long()

    if combine == "count":
        combined = _segment(torch.ones_like(values), ids, out_size + 1, "sum")
    else:
        reduce = {"sum": "sum", "min": "amin", "max": "amax"}[combine]
        combined = _segment(values, ids, out_size + 1, reduce)
    combined = combined[:out_size]

    # First row of each kept segment (scatter-min), then a gather of only
    # out_size key rows.
    start_ids = torch.where(boundary, torch.clamp(seg, max=out_size), out_size).long()
    start = _segment(
        torch.arange(n, dtype=torch.int32, device=dev), start_ids, out_size + 1, "amin"
    )[:out_size]
    o_lanes, o_values, o_valid = (None,) * 3 if out is None else out.tensors()
    out_valid = torch.lt(torch.arange(out_size, dtype=torch.int32, device=dev), num_segments,
                         out=o_valid)
    safe_start = torch.where(out_valid, start, 0).long()
    out_lanes = torch.mul(lanes[safe_start], out_valid[:, None].to(lanes.dtype), out=o_lanes)
    out_values = torch.where(out_valid, combined, 0)
    if o_values is not None:  # where() takes no out= with a scalar
        out_values = o_values.copy_(out_values)
    return KVBatch(key_lanes=out_lanes, values=out_values, valid=out_valid), num_segments


def segment_reduce(batch: KVBatch, combine: str = "sum") -> KVBatch:
    """Same-capacity special case of ``segment_reduce_into``: the first
    ``num_segments`` rows are the unique keys (in order) with combined
    values; the tail is invalid."""
    return segment_reduce_into(batch, batch.size, combine)[0]
