"""Fold-level reduce: the sort-free hash-table fold and the sort fold.

Port of ``locust_tpu/ops/hash_table.py``.  ``reduce_into`` / ``fold_into``
are the one place a fold picks its strategy: the sort modes sort
``concat(acc, batch)`` and segment-reduce it; the hasht family
(config.HASHT_FAMILY) aggregates it into an open-addressed table with
``aggregate_exact``, no sort on the common path.

Per probe round of ``hash_aggregate`` (double hashing,
``slot_p = (h1 + p * (h2 | 1)) % T``):

1. rows compete for their slot by a scatter-min over the 31-bit folded
   hash ``h1 >> 1``: the winner per slot is the smallest folded hash;
2. winners whose slot is empty write their key lanes (rows of one key
   write the same bytes; two distinct keys can both win only on a
   folded-hash collision, and then the duplicate-index row write may
   interleave, which is why step 3, not the write, marks a slot used);
3. every unresolved row compares ALL key lanes with its slot's: only an
   exact match resolves it, so hash collisions never merge keys;
4. resolved rows combine their values into the slot (``index_add_`` /
   ``scatter_reduce_``: int32 atomics on CUDA, exact in any order).

Rows no probe resolves go down ``aggregate_exact``'s ladder: none, the
table is the answer; at most ``RESIDUAL_CAP``, ``place_residual`` sorts
them in a small buffer and puts each key in an empty slot; more, the
stock sort + segment reduce over the table and those rows.  The final
table is a function of the batch's distinct keys and their totals alone.

uint32 arithmetic is done in int64 masked to 32 bits (core/packing.py),
and every boolean selection is a ``where`` into a dump row, so the fold
adds no host sync but the ladder's one read of the unresolved count.
"""

from __future__ import annotations

import torch

from locust_tpu_torch.config import HASHT_FAMILY, HASHT_PROBES
from locust_tpu_torch.core import packing
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.ops.process_stage import sort_and_compact
from locust_tpu_torch.ops.reduce_stage import segment_reduce_into

# How the probe loop's value combine is spelled: "xla" is the
# duplicate-index scatter (named as in the JAX package), "mxu" the one-hot
# matrix product of mxu_scatter_add.  Both give bit-identical tables.
SCATTER_IMPLS = ("xla", "mxu")

# mxu_scatter_add's matrix shapes: slot = hi * MXU_LANES + lo, and rows per
# one-hot chunk.  They shape the products only; the sums are the same for
# any value.  A chunk's float32 partial sums of 8-bit limbs are exact while
# 255 * chunk < 2^24, so a chunk is at most 65,536 rows.
MXU_LANES = 512
MXU_CHUNK = 32768

# Residual buffer of place_residual: more unresolved rows than this take
# the full sort fallback.
RESIDUAL_CAP = 4096

# Combine identities; "count" is refused (aggregate_exact) because it is
# not associative over partial tables.
_COMBINE_INIT = {"sum": 0, "min": 2**31 - 1, "max": -(2**31)}


def scatter_impl_for(sort_mode: str) -> str:
    """The fold family's mode -> combine spelling."""
    return "mxu" if sort_mode == "hasht-mxu" else "xla"


def mxu_scatter_add(
    slot: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    out_size: int,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Duplicate-index scatter-add spelled as one-hot matrix products.

    Returns ``(sums, hit)``: ``sums[t]`` is the int32 sum (mod 2^32) of
    ``values`` over masked rows with ``slot == t``, ``hit[t]`` whether any
    masked row landed there.  The value's four unsigned 8-bit limbs and
    the hit count are five weight planes; per chunk of rows, one float32
    ``[t_hi * 5, chunk] x [chunk, t_lo]`` product sums them per grid cell.
    Every operand is an integer <= 255 and every partial sum < 2^24, so
    float32 is exact; partials accumulate mod 2^32 and the limbs
    recombine mod 2^32, the ring of an int32 scatter-add.
    """
    t_lo = min(MXU_LANES, out_size)
    t_hi = -(-out_size // t_lo)
    chunk = MXU_CHUNK if chunk is None else chunk
    if not 1 <= chunk <= 65536:
        raise ValueError(
            f"chunk must be in [1, 65536] (fp32 partial-sum exactness "
            f"bound 2^24/255), got {chunk}"
        )
    dev = slot.device
    w_u = torch.where(mask, packing.to_u32(values), 0)
    planes = [(w_u >> (8 * b)) & 0xFF for b in range(4)] + [mask.to(torch.int64)]
    weights = torch.stack(planes, dim=-1).to(torch.float32)      # [n, 5]
    s64 = slot.to(torch.int64)
    hi, lo = s64 // t_lo, s64 % t_lo
    iota_hi = torch.arange(t_hi, device=dev)
    iota_lo = torch.arange(t_lo, device=dev)
    acc = torch.zeros((t_hi, 5, t_lo), dtype=torch.int64, device=dev)
    for c0 in range(0, slot.shape[0], chunk):
        hi_c, lo_c, w_c = hi[c0:c0 + chunk], lo[c0:c0 + chunk], weights[c0:c0 + chunk]
        oh_hi = (hi_c[:, None] == iota_hi).to(torch.float32)      # [c, t_hi]
        oh_lo = (lo_c[:, None] == iota_lo).to(torch.float32)      # [c, t_lo]
        lhs = (oh_hi[:, :, None] * w_c[:, None, :]).reshape(-1, t_hi * 5)
        part = (lhs.T @ oh_lo).reshape(t_hi, 5, t_lo)
        acc = (acc + part.to(torch.int64)) & packing.MASK32
    sums_u = acc[:, 0] + (acc[:, 1] << 8) + (acc[:, 2] << 16) + (acc[:, 3] << 24)
    sums = packing.to_i32(sums_u.reshape(-1)[:out_size])
    hit = acc[:, 4].reshape(-1)[:out_size] > 0
    return sums, hit


def hash_aggregate(
    batch: KVBatch,
    out_size: int,
    combine: str = "sum",
    probes: int = HASHT_PROBES,
    table: KVBatch | None = None,
    scatter_impl: str = "xla",
) -> tuple[KVBatch, torch.Tensor, torch.Tensor]:
    """Aggregate ``batch`` into an ``out_size``-slot table without sorting.

    With ``table`` (capacity ``out_size``, from an earlier hasht fold) the
    aggregation is incremental: prior keys keep their slots.  Returns
    ``(table, used_count, unresolved_mask)``: used slots hold one
    distinct key each with its combined value (slot order); the int32
    count of used slots; and the ``[N]`` rows the caller must still fold
    in exactly (rows whose lane 0 is 0, which would alias the empty-slot
    sentinel, are among them).
    """
    if combine not in _COMBINE_INIT:
        raise ValueError(f"combine must be one of {sorted(_COMBINE_INIT)}")
    if scatter_impl not in SCATTER_IMPLS:
        raise ValueError(
            f"scatter_impl must be one of {SCATTER_IMPLS}, got {scatter_impl!r}"
        )
    lanes, values, valid = batch.key_lanes, batch.values, batch.valid
    n_lanes = lanes.shape[-1]
    dev = lanes.device
    T = out_size
    init = _COMBINE_INIT[combine]

    h1, h2 = (packing.to_u32(h) for h in packing.hash_pair(lanes))
    folded = h1 >> 1                        # < 0x7FFFFFFF < the sentinel
    step = h2 | 1
    sentinel = packing.MASK32
    unresolved = valid & (lanes[:, 0] != 0)

    # Row T of each array is a dump row: it takes the writes of rows that
    # must not write, so no selection needs a host-side count.
    if table is None:
        stored = torch.zeros((T + 1, n_lanes), dtype=torch.int32, device=dev)
        acc = torch.full((T + 1,), init, dtype=torch.int32, device=dev)
        matched = torch.zeros((T + 1,), dtype=torch.bool, device=dev)
    else:
        if table.size != T:
            raise ValueError(
                f"incremental table capacity {table.size} != out_size {T}"
            )
        pad_lanes = torch.zeros((1, n_lanes), dtype=torch.int32, device=dev)
        stored = torch.cat([torch.where(table.valid[:, None], table.key_lanes, 0), pad_lanes])
        acc = torch.cat([
            torch.where(table.valid, table.values, init),
            torch.full((1,), init, dtype=torch.int32, device=dev),
        ])
        # Slots carried in were matched when first inserted.
        matched = torch.cat([table.valid, torch.zeros((1,), dtype=torch.bool, device=dev)])
    # A slot counts as used only once a row has matched its FULL key: two
    # distinct keys sharing a folded hash can both win an empty slot and
    # interleave their key writes into bytes that match neither, and such
    # a slot must not surface as a row.

    for p in range(probes):
        slot = ((h1 + p * step) & packing.MASK32) % T
        # 1. Compete: the smallest folded hash wins the slot this round.
        claim = torch.full((T,), sentinel, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(
            0, slot, torch.where(unresolved, folded, sentinel), reduce="amin"
        )
        won = unresolved & (claim[slot] == folded)
        # 2. Winners write their key into EMPTY slots.
        empty = stored[:T, 0] == 0
        writer = won & empty[slot]
        stored.index_put_((torch.where(writer, slot, T),), lanes)
        # 3. Resolve by full-key equality with what the slot holds.
        match = unresolved & (stored[slot] == lanes).all(dim=-1)
        # 4. Combine resolved values into the slot.
        if scatter_impl == "mxu" and combine == "sum":
            sums, hit = mxu_scatter_add(slot, values, match, T)
            acc[:T] += sums
            matched[:T] |= hit
        else:
            vslot = torch.where(match, slot, T)
            matched.index_fill_(0, vslot, True)
            if combine == "sum":
                acc.index_add_(0, vslot, values)
            else:
                reduce = "amin" if combine == "min" else "amax"
                acc.scatter_reduce_(0, vslot, values, reduce=reduce)
        unresolved = unresolved & ~match

    used = (stored[:T, 0] != 0) & matched[:T]
    out = KVBatch(
        key_lanes=stored[:T],
        values=torch.where(used, acc[:T], 0),
        valid=used,
    )
    # Rows kept out of the probes (lane 0 == 0) come back as unresolved:
    # everything not in the table is handed back to the caller.
    unresolved = unresolved | (valid & (lanes[:, 0] == 0))
    return out, used.sum(dtype=torch.int32), unresolved


def place_residual(
    table: KVBatch,
    used: torch.Tensor,
    batch: KVBatch,
    unresolved: torch.Tensor,
    combine: str = "sum",
) -> tuple[KVBatch, torch.Tensor]:
    """Exactly fold the ``unresolved`` rows of ``batch`` into ``table``
    (caller guarantees at most ``RESIDUAL_CAP`` of them): compact them
    into a small buffer, group and total it with the stock sort + segment
    reduce, and put the k-th residual key into the k-th empty slot.  Keys
    beyond the empty slots are dropped but counted in the returned
    distinct total, so a truncation stays observable.

    Returns ``(merged_table, distinct_total)``.
    """
    T = table.size
    n_lanes = table.key_lanes.shape[-1]
    cap = RESIDUAL_CAP
    dev = table.key_lanes.device

    # 1. Compact unresolved rows into the buffer (row cap = dump).
    pos = torch.cumsum(unresolved.to(torch.int32), 0, dtype=torch.int32) - 1
    idx = (torch.where(unresolved & (pos < cap), pos, cap).long(),)
    rlanes = torch.zeros((cap + 1, n_lanes), dtype=torch.int32, device=dev)
    rlanes.index_put_(idx, batch.key_lanes)
    rvals = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    rvals.index_put_(idx, batch.values)
    rvalid = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
    rvalid.index_put_(idx, unresolved)
    rbatch = KVBatch(rlanes[:cap], rvals[:cap], rvalid[:cap])

    # 2. Group + total the residual keys (a small sort).
    rtab, rdist = segment_reduce_into(sort_and_compact(rbatch, "hashp1"), cap, combine)

    # 3. k-th residual key -> k-th empty slot.
    empty = ~table.valid
    erank = torch.cumsum(empty.to(torch.int32), 0, dtype=torch.int32) - 1
    slot_by_rank = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
    slot_by_rank.index_put_(
        (torch.where(empty & (erank < cap), erank, cap).long(),),
        torch.arange(T, device=dev),
    )
    n_empty = T - used
    placeable = rtab.valid & (
        torch.arange(cap, device=dev) < torch.clamp(n_empty, max=cap)
    )
    target = (torch.where(placeable, slot_by_rank[:cap], T),)

    pad_lanes = torch.zeros((1, n_lanes), dtype=torch.int32, device=dev)
    lanes = torch.cat([table.key_lanes, pad_lanes]).index_put_(target, rtab.key_lanes)
    vals = torch.cat([table.values, torch.zeros((1,), dtype=torch.int32, device=dev)])
    vals.index_put_(target, rtab.values)
    ok = torch.cat([table.valid, torch.zeros((1,), dtype=torch.bool, device=dev)])
    ok.index_put_(target, placeable)
    return KVBatch(lanes[:T], vals[:T], ok[:T]), used + rdist


def aggregate_exact(
    batch: KVBatch,
    out_size: int,
    combine: str = "sum",
    probes: int | None = None,
    scatter_impl: str = "xla",
) -> tuple[KVBatch, torch.Tensor]:
    """The sort-free fold with its exactness ladder: ``hash_aggregate``,
    then by the number of unresolved rows: 0, the table; <= RESIDUAL_CAP,
    ``place_residual``; more, the stock sort + segment reduce of the table
    with those rows.  (The JAX package's incremental ``into=`` has no
    caller: ``fold_into`` rebuilds the table from ``concat(acc, batch)``.)

    Returns ``(table[out_size], distinct)``, the distinct count taken
    before the capacity cut.
    """
    if combine == "count":
        # "count" is not a monoid over its own outputs: the ladder's
        # fallbacks re-reduce batches holding pre-aggregated table rows.
        raise ValueError(
            "aggregate_exact cannot take combine='count' (not associative "
            "over partial tables); lower it via "
            "reduce_stage.normalize_combine to emit-1 + 'sum' first"
        )
    table, used, unresolved = hash_aggregate(
        batch, out_size, combine,
        probes=HASHT_PROBES if probes is None else probes,
        scatter_impl=scatter_impl,
    )
    # The JAX package's lax.cond is a host branch here: one host read of
    # the unresolved count per fold (on CUDA a device sync).
    n_unres = int(unresolved.sum(dtype=torch.int32))
    if n_unres == 0:
        return table, used
    if n_unres <= RESIDUAL_CAP:
        return place_residual(table, used, batch, unresolved, combine)
    resid = KVBatch(batch.key_lanes, batch.values, unresolved)
    return segment_reduce_into(
        sort_and_compact(KVBatch.concat(table, resid), "hashp1"), out_size, combine
    )


def reduce_into(
    batch: KVBatch, out_size: int, combine: str, sort_mode: str
) -> tuple[KVBatch, torch.Tensor]:
    """Reduce ``batch`` into a bounded ``out_size`` table; returns
    ``(table, num_segments)``.  The one place a fold picks sort or hasht."""
    if sort_mode in HASHT_FAMILY:
        return aggregate_exact(
            batch, out_size, combine, scatter_impl=scatter_impl_for(sort_mode)
        )
    return segment_reduce_into(sort_and_compact(batch, sort_mode), out_size, combine)


def fold_into(
    acc: KVBatch, batch: KVBatch, out_size: int, combine: str, sort_mode: str
) -> tuple[KVBatch, torch.Tensor]:
    """Fold NEW rows into an existing bounded table produced by an earlier
    fold at the same ``(out_size, combine, sort_mode)``.  The hasht family
    rebuilds the table from ``concat(acc, batch)`` each fold, as the JAX
    package does (its incremental mode lets stranded keys gather duplicate
    rows fold after fold)."""
    return reduce_into(KVBatch.concat(acc, batch), out_size, combine, sort_mode)
