"""Inputs for the stable counting partition's tests
(``ops/kernels/partition.stable_partition``): skewed buckets, invalid rows
scattered through the batch, and a payload, made with numpy from a seed,
and the partition's slots written out row by row in Python."""

import numpy as np
import torch


def batch(n: int, n_bins: int, seed: int, n_lanes: int = 3, hot: float = 0.0,
          invalid: float = 0.1, out_of_range: float = 0.0,
          payload_shape: tuple | None = None, payload_dtype=np.int32):
    """``(bucket, valid, lanes, values, payload)`` CPU tensors of ``n`` rows:
    a ``hot`` share of the rows in bucket 0, the rest uniform over the
    bins, an ``invalid`` share of rows invalid and an ``out_of_range``
    share with a bucket of ``n_bins`` or -1; payload ``[n, *shape]`` or
    None."""
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, n_bins, n)
    bucket[rng.random(n) < hot] = 0
    far = rng.random(n) < out_of_range
    bucket[far] = np.where(rng.random(int(far.sum())) < 0.5, n_bins, -1)
    lanes = rng.integers(-2**31, 2**31, (n, n_lanes), dtype=np.int64).astype(np.int32)
    values = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    valid = rng.random(n) >= invalid
    payload = None
    if payload_shape is not None:
        payload = torch.from_numpy(
            rng.integers(0, 2**62, (n, *payload_shape), dtype=np.int64).astype(payload_dtype))
    return (torch.from_numpy(bucket.astype(np.int64)), torch.from_numpy(valid),
            torch.from_numpy(lanes), torch.from_numpy(values), payload)


def slots_by_hand(bucket, valid, lanes, values, n_bins, cap, lcap, payload=None):
    """The partition's ``(rows, overflow, binned, totals)`` walked row by
    row: bin ``b`` takes its valid rows in input order up to ``cap``, the
    rest go to the leftover in (bucket, input) order up to ``lcap``; the
    payload of an empty slot is zero; ``totals`` counts each bin's valid
    rows, kept or not."""
    n, n_lanes = lanes.shape
    rows = np.zeros((n_bins * cap + lcap, n_lanes + 2), np.int32)
    binned = None if payload is None else np.zeros((n_bins * cap, payload.shape[1]),
                                                   payload.numpy().dtype)
    fill = [0] * n_bins
    totals = [0] * n_bins
    spilled = [[] for _ in range(n_bins)]
    for r in range(n):
        b = int(bucket[r])
        if not bool(valid[r]) or not 0 <= b < n_bins:
            continue
        totals[b] += 1
        if fill[b] < cap:
            slot = b * cap + fill[b]
            rows[slot, :n_lanes] = lanes[r].numpy()
            rows[slot, n_lanes:] = (int(values[r]), 1)
            if binned is not None:
                binned[slot] = payload[r].numpy()
            fill[b] += 1
        else:
            spilled[b].append(r)
    order = [r for b in range(n_bins) for r in spilled[b]]
    for i, r in enumerate(order[:lcap]):
        rows[n_bins * cap + i, :n_lanes] = lanes[r].numpy()
        rows[n_bins * cap + i, n_lanes:] = (int(values[r]), 1)
    if binned is not None:
        binned = binned.reshape(n_bins, cap, payload.shape[1])
    return rows, max(0, len(order) - lcap), binned, totals


def bins_at_under_and_over(cap: int, seed: int):
    """``(bucket, valid, lanes, values)`` CPU tensors whose 4 bins hold
    exactly ``cap`` valid rows (bin 0), fewer (bin 1), more (bin 2) and
    none (bin 3), shuffled among invalid rows and rows out of range; and
    the valid rows a bin, ``[cap, cap // 3, 2 * cap + 17, 0]``."""
    totals = [cap, cap // 3, 2 * cap + 17, 0]
    rng = np.random.default_rng(seed)
    bucket = np.concatenate([np.full(t, b) for b, t in enumerate(totals)] +
                            [rng.integers(0, 4, cap // 2), np.full(cap // 4, 4),
                             np.full(cap // 4, -1)])
    valid = np.arange(bucket.size) < sum(totals)
    valid[sum(totals) + cap // 2:] = True  # out of range: valid, yet in no bin
    order = rng.permutation(bucket.size)
    n = bucket.size
    lanes = rng.integers(-2**31, 2**31, (n, 3), dtype=np.int64).astype(np.int32)
    values = np.arange(n, dtype=np.int32)
    return (torch.from_numpy(bucket[order].astype(np.int64)), torch.from_numpy(valid[order]),
            torch.from_numpy(lanes), torch.from_numpy(values)), totals
