"""The shuffle's stable counting partition (``csrc/partition.cu``) and its
plain PyTorch version.

No TPU kernel corresponds to this one: the JAX package's
``parallel/shuffle.partition_to_bins`` is a ``jnp`` stable sort and
scatter.  ``stable_partition`` writes every valid row of a batch into its
slot of ``n_bins`` bins of ``bin_capacity`` slots, as the packed int32
rows the all-to-all sends (``L`` lanes, the value, a valid word):

- bin ``b``, slot ``j``: the ``j``-th valid row of bucket ``b`` in input
  order, for ``j < bin_capacity``;
- valid rows past their bin's capacity go to the ``leftover_capacity``
  leftover rows after the bins, in (bucket, input) order; what fits
  neither is counted in ``overflow``;
- empty slots: zero lanes and value, valid word 0.

Each bin's total, its valid rows before the capacity is applied, comes
back beside the slots (the kernel's scan writes it); a bin's first
``min(total, bin_capacity)`` slots are the filled ones.

A row whose bucket lies outside ``[0, n_bins)`` goes nowhere, like an
invalid row.  Given a ``payload`` (``[N, W]`` whose rows are whole
4-byte words, as the sample sort's int32 record words are), each row's
payload lands in the same slot of a ``[n_bins, bin_capacity, W]``
output; the payload of an empty slot is unspecified (the kernel leaves
it unwritten, the plain version zeroes it).

The wrapper launches the kernel for CUDA tensors (counted in
``stable_partition.launches`` and the counter
``shuffle.partition_launches``, one a call: its histogram, scan and
scatter) and takes the plain version, the stable sort and scatters as
torch ops, only for CPU tensors.  It refuses what the kernel does not
take, on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from locust_tpu_torch import _build, obs
from locust_tpu_torch.ops.kernels import KernelLaunchError
from locust_tpu_torch.ops.kernels.tokenize import device_guard, stream_handle

# The most bins the kernel takes: its shared-memory histogram holds one
# count a bin (``kMaxBins`` in csrc/partition.cu).
MAX_BINS = 1024
_INDEX_LIMIT = 2**31


def _plain(bucket, valid, lanes, values, n_bins, cap, lcap, payload):
    """The same slots as torch ops on any device: a stable sort of the
    buckets, each row's rank in its bin, and scatters of the packed rows
    (and the payload) into them, a dump row taking the rest; the bins'
    totals are the sorted buckets' counts."""
    n, n_lanes = lanes.shape
    dev = lanes.device
    keep = valid & (bucket >= 0) & (bucket < n_bins)
    sb, sidx = torch.sort(torch.where(keep, bucket, n_bins), stable=True)
    counts = torch.bincount(sb, minlength=n_bins + 1)
    within = torch.arange(n, device=dev) - (torch.cumsum(counts, 0) - counts)[sb]
    live = sb < n_bins
    ok = live & (within < cap)
    spill = live & (within >= cap)
    lrank = torch.cumsum(spill.to(torch.int32), 0, dtype=torch.int32) - 1
    kept = spill & (lrank < lcap)
    flat = n_bins * cap
    dump = flat + lcap
    dest = torch.where(ok, sb * cap + within, torch.where(kept, flat + lrank.long(), dump))
    packed = torch.cat([lanes[sidx], values[sidx, None],
                        torch.ones((n, 1), dtype=torch.int32, device=dev)], dim=1)
    rows = torch.zeros((dump + 1, n_lanes + 2), dtype=torch.int32, device=dev)
    rows.index_put_((dest,), packed)
    overflow = (spill & (lrank >= lcap)).sum(dtype=torch.int32)
    binned = None
    if payload is not None:
        binned = payload.new_zeros((flat + 1, payload.shape[1]))
        binned.index_put_((torch.where(ok, dest, flat),), payload[sidx])
        binned = binned[:flat].reshape(n_bins, cap, payload.shape[1])
    return rows[:dump], overflow, binned, counts[:n_bins].to(torch.int32)


@functools.cache
def _lib():
    lib = _build.load("partition")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.locust_partition.argtypes = [p, p, p, i, p, p, i, p, p, p, p, ll, i, ll, ll, p]
    lib.locust_partition.restype = i
    lib.locust_partition_tile_rows.argtypes = []
    lib.locust_partition_tile_rows.restype = i
    return lib


def _check(bucket, valid, lanes, values, n_bins, cap, lcap, payload) -> None:
    """Raise ``ValueError`` on what the kernel does not take."""
    dev = lanes.device
    if lanes.dim() != 2 or lanes.shape[1] < 1:
        raise ValueError(f"partition: lanes must be [N, L], L >= 1, not {tuple(lanes.shape)}")
    n = lanes.shape[0]
    for name, t, dtype, shape in (("lanes", lanes, torch.int32, (n, lanes.shape[1])),
                                  ("values", values, torch.int32, (n,)),
                                  ("valid", valid, torch.bool, (n,)),
                                  ("bucket", bucket, torch.int64, (n,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"partition: {name} must be {shape} of {dtype}, not "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"partition: {name} must be contiguous on {dev}")
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"partition: n_bins {n_bins} outside 1..{MAX_BINS}")
    if cap < 0 or lcap < 0:
        raise ValueError(f"partition: capacities must be >= 0, not {cap} and {lcap}")
    if n >= _INDEX_LIMIT or n_bins * cap + lcap >= _INDEX_LIMIT:
        raise ValueError(f"partition: {n} rows into {n_bins * cap + lcap} slots: the "
                         "kernel's int32 ranks and slots hold fewer than 2**31")
    if payload is not None:
        if payload.dim() != 2 or payload.shape[0] != n:
            raise ValueError(f"partition: payload must be [{n}, W], not "
                             f"{tuple(payload.shape)}")
        if payload.device != dev or not payload.is_contiguous():
            raise ValueError(f"partition: payload must be contiguous on {dev}")
        if payload.shape[1] * payload.element_size() % 4 or payload.data_ptr() % 4:
            raise ValueError("partition: payload rows must be whole 4-byte words, 4-byte "
                             f"aligned, not {payload.shape[1]} of {payload.dtype}")
        if lcap > 0:
            raise ValueError("partition: a payload goes to the bins only; "
                             "leftover_capacity must be 0 with one")


def stable_partition(bucket: torch.Tensor, valid: torch.Tensor, lanes: torch.Tensor,
                     values: torch.Tensor, n_bins: int, bin_capacity: int,
                     leftover_capacity: int = 0, payload: torch.Tensor | None = None):
    """Rows ``bucket`` (int64 ``[N]``), ``valid`` (bool ``[N]``),
    ``lanes`` (int32 ``[N, L]``) and ``values`` (int32 ``[N]``) into
    their slots, all contiguous on one device.  Returns ``(rows, overflow,
    binned, totals)``: ``rows`` int32 ``[n_bins * bin_capacity +
    leftover_capacity, L + 2]``, the bins then the leftover; ``overflow``
    an int32 scalar tensor; ``binned`` the payload's ``[n_bins,
    bin_capacity, W]`` or None; ``totals`` int32 ``[n_bins]``, each bin's
    valid rows, its capacity not applied (on a card a view of the scan's
    output: no launch of its own).  A payload needs ``leftover_capacity``
    0."""
    n_bins, cap, lcap = int(n_bins), int(bin_capacity), int(leftover_capacity)
    _check(bucket, valid, lanes, values, n_bins, cap, lcap, payload)
    dev = lanes.device
    if dev.type == "cpu":
        return _plain(bucket, valid, lanes, values, n_bins, cap, lcap, payload)
    if dev.type != "cuda":
        raise ValueError(f"partition: no kernel for device {dev}")
    n, n_lanes = lanes.shape
    lib = _lib()
    tiles = max(1, -(-n // lib.locust_partition_tile_rows()))
    rows = torch.empty((n_bins * cap + lcap, n_lanes + 2), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    workspace = torch.empty(n_bins * tiles + 2 * n_bins + 2, dtype=torch.int32, device=dev)
    words, src, binned, out = 0, None, None, None
    if payload is not None:
        src = payload.view(torch.int32)
        words = src.shape[1]
        out = torch.empty((n_bins, cap, words), dtype=torch.int32, device=dev)
        binned = out.view(payload.dtype)
    with device_guard(dev):
        rc = lib.locust_partition(
            bucket.data_ptr(), valid.data_ptr(), lanes.data_ptr(),
            n_lanes, values.data_ptr(), None if src is None else src.data_ptr(), words,
            None if out is None else out.data_ptr(), rows.data_ptr(),
            overflow.data_ptr(), workspace.data_ptr(), n, n_bins, cap, lcap,
            stream_handle(dev))
    if rc != 0:
        raise KernelLaunchError(f"partition kernel launch failed: cudaError {rc}")
    stable_partition.launches += 1
    obs.metric_inc("shuffle.partition_launches")
    totals = workspace[n_bins * tiles:n_bins * tiles + n_bins]
    return rows, overflow, binned, totals


stable_partition.launches = 0
