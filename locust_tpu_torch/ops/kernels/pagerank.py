"""PageRank's ordered gather-add (``csrc/pagerank.cu``), its plain
PyTorch versions, and the in-edge grouping it walks.

No TPU kernel corresponds to this one: it gives the card the CPU's
order of adds.  Per node ``v``::

    total[v] = init + c(e1) + c(e2) + ...     (left to right)

over v's in-edges ``e1, e2, ...`` in edge order, each contribution
``c(e) = ranks[src[e]] * inv_deg[src[e]]`` rounded to float32 before its
add.  That is what ``index_add_`` computes on the CPU, where it adds in
index order, and what the JAX package's scatter-add computes on the CPU;
on CUDA ``index_add_`` adds in no fixed order.

Sources and rows may be two index spaces (``num_src`` sources, indexing
``ranks`` and ``inv_deg``, and ``num_nodes`` rows, indexing ``total``):
one device's PageRank has one, the sharded PageRank's send sum (a
rank's local nodes into its send slots) and receive sum (the received
slots into its local nodes) have two.  With no ``inv_deg`` the sum is
unweighted, ``c(e) = ranks[src[e]]``: the receive sum's slots are
already products.

``in_edges`` builds the ``Grouping`` the kernel walks, once per graph (it
is loop-invariant): the node schedule (node ids by in-degree, largest
first, a stable sort), the in-edges grouped into one row per node in the
schedule's order (a stable sort, so each row keeps edge order: the CSR
offsets by schedule position and the sources in that order) and the
number of warp rows (rows of more than ``WARP_ROW_THRESHOLD`` in-edges: a
warp each; the rest a thread each), with int32 indices where the graph
fits (``index_dtype``).  Its fields unpack in order into ``gather_add``.
``gather_add`` launches the kernel for a CUDA tensor (and counts it in
``gather_add.launches``) and takes the plain version, ``index_add_`` over
the grouped edges, only for a CPU tensor.  The kernel writes each
source's product ``ranks[v] * inv_deg[v]`` once, into a scratch vector of
``num_src`` floats, and each edge gathers one of them: the same float32
product the edge would compute itself, so the same bits, with one random
4-byte read an edge and no per-edge array.  ``csr_walk_reference`` is the
same walk as torch ops, in order on any device: the card check holds the
kernel against it bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from locust_tpu_torch import _build
from locust_tpu_torch.ops.kernels import KernelLaunchError
from locust_tpu_torch.ops.kernels.tokenize import device_guard, stream_handle


# Rows with more in-edges than this take a warp each, the rest a thread.
WARP_ROW_THRESHOLD = 64


class Grouping(NamedTuple):
    """The in-edge grouping the kernel walks; it unpacks in order into
    ``gather_add``'s arguments after ``init``."""

    offsets: torch.Tensor  # [num_nodes + 1] CSR offsets of the rows, by schedule position
    src_by_dst: torch.Tensor  # [E] each row's sources, edge order kept
    schedule: torch.Tensor  # [num_nodes] row i is node schedule[i]; largest first
    warp_rows: int  # the first rows, those that take a warp each


def index_dtype(num_nodes: int, num_edges: int, num_src: int = 0) -> torch.dtype:
    """int32 when every index and offset fits (``num_nodes + 1``, the
    edge count and the source count below 2^31), else int64."""
    return torch.int32 if max(num_nodes + 1, num_edges, num_src) < 2**31 else torch.int64


def in_edges(src: torch.Tensor, dst: torch.Tensor, num_nodes: int,
             threshold: int = WARP_ROW_THRESHOLD, dtype: torch.dtype | None = None,
             num_src: int | None = None) -> Grouping:
    """The ``Grouping`` of the edges ``src[i] -> dst[i]`` on their device,
    ``dst`` in ``[0, num_nodes)`` and ``src`` in ``[0, num_src)``
    (``num_nodes`` by default): the schedule a stable sort of the
    in-degrees, largest first; one row per node in that order, each its
    in-edges in edge order (a stable sort of the edges by their
    destination's schedule position); warp rows those of more than
    ``threshold`` in-edges.  Indices are ``dtype``, by default
    ``index_dtype``'s choice."""
    s, d = src.to(torch.int64), dst.to(torch.int64)
    counts = torch.bincount(d, minlength=num_nodes)
    schedule = torch.sort(counts, descending=True, stable=True).indices
    position = torch.empty_like(schedule)
    position[schedule] = torch.arange(num_nodes, device=d.device)
    order = torch.sort(position[d], stable=True).indices
    offsets = torch.zeros(num_nodes + 1, dtype=torch.int64, device=d.device)
    torch.cumsum(counts[schedule], 0, out=offsets[1:])
    it = dtype or index_dtype(num_nodes, s.shape[0], num_nodes if num_src is None else num_src)
    return Grouping(offsets.to(it), s[order].to(it), schedule.to(it),
                    int((counts > threshold).sum()))  # locust: noqa[R003] once per graph: callers build the grouping before the iterations and pass it to every pagerank_step


def csr_walk_reference(init: torch.Tensor, offsets: torch.Tensor, src_by_dst: torch.Tensor,
                       schedule: torch.Tensor, warp_rows: int, ranks: torch.Tensor,
                       inv_deg: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version as explicit adds in order, on any device: the rows
    sorted by length, step ``j`` adds every row's ``j``-th contribution
    (the rows of more than ``j`` edges are a prefix) to its node's total;
    ``warp_rows`` changes nothing here."""
    n = offsets.shape[0] - 1
    contrib = _products(src_by_dst, ranks, inv_deg)
    deg = offsets[1:] - offsets[:-1]
    by_deg = torch.sort(deg, descending=True, stable=True).indices
    start, deg_sorted, node = offsets[:-1][by_deg], deg[by_deg], schedule[by_deg].long()
    acc = init.to(torch.float32).expand(n).clone()
    for j in range(int(deg_sorted[0]) if n else 0):
        live = int((deg_sorted > j).sum())  # locust: noqa[R003] the kernel's plain version adds the rows' j-th contributions in order: one read of the live row count per step j
        nodes = node[:live]
        acc[nodes] = acc[nodes] + contrib[start[:live] + j]
    return acc


def _products(src_by_dst: torch.Tensor, ranks: torch.Tensor,
              inv_deg: torch.Tensor | None) -> torch.Tensor:
    """Each edge's contribution in the grouping's order."""
    if inv_deg is None:
        return ranks[src_by_dst]
    return ranks[src_by_dst] * inv_deg[src_by_dst]


def _plain(init, offsets, src_by_dst, schedule, warp_rows, ranks, inv_deg=None) -> torch.Tensor:
    """Plain version for a CPU tensor: ``index_add_`` in the grouping's
    order (the CPU adds in index order)."""
    n = offsets.shape[0] - 1
    dst_sorted = torch.repeat_interleave(schedule.long(), (offsets[1:] - offsets[:-1]).long())
    return init.expand(n).clone().index_add_(
        0, dst_sorted, _products(src_by_dst, ranks, inv_deg))


@functools.cache
def _kernel():
    fn = _build.load("pagerank").locust_pagerank_gather_add
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def gather_add(init: torch.Tensor, offsets: torch.Tensor, src_by_dst: torch.Tensor,
               schedule: torch.Tensor, warp_rows: int, ranks: torch.Tensor,
               inv_deg: torch.Tensor | None = None) -> torch.Tensor:
    """``total[v] = init + sum of v's contributions in edge order``:
    float32 ``[num_nodes]`` on ``ranks``'s device.  ``init`` is a float32
    scalar tensor; ``offsets``, ``src_by_dst``, ``schedule`` and
    ``warp_rows`` the fields of ``in_edges``'s ``Grouping`` (sources, not
    edge indices; int32 or int64, all three alike; ``num_nodes`` rows);
    ``ranks``/``inv_deg`` float32 ``[num_src]``, indexed by source; no
    ``inv_deg`` for an unweighted sum."""
    dev = ranks.device
    if dev.type == "cpu":
        return _plain(init, offsets, src_by_dst, schedule, warp_rows, ranks, inv_deg)
    if dev.type != "cuda":
        raise ValueError(f"pagerank gather-add: no kernel for device {dev}")
    n = offsets.shape[0] - 1
    it = offsets.dtype
    if it not in (torch.int32, torch.int64):
        raise ValueError(f"pagerank gather-add: indices must be int32 or int64, not {it}")
    args = [init.reshape(1), offsets, src_by_dst, schedule, ranks, inv_deg]
    for name, t, dtype in zip(("init", "offsets", "src_by_dst", "schedule", "ranks", "inv_deg"),
                              args, (torch.float32, it, it, it, torch.float32, torch.float32)):
        if t is not None and (t.device != dev or t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(f"pagerank gather-add: {name} must be a contiguous {dtype} "
                             f"tensor on {dev}")
    num_src = ranks.shape[0]
    if inv_deg is not None and inv_deg.shape[0] != num_src:
        raise ValueError("pagerank gather-add: ranks and inv_deg must have one row per source")
    if schedule.shape[0] != n:
        raise ValueError("pagerank gather-add: the schedule must have num_nodes rows")
    if not 0 <= warp_rows <= n:
        raise ValueError(f"pagerank gather-add: warp_rows {warp_rows} outside 0..{n}")
    total = torch.empty(n, dtype=torch.float32, device=dev)
    # Each source's product, written by the kernel's first phase and
    # gathered once an edge; an unweighted sum gathers ``ranks`` itself.
    scratch = torch.empty(num_src if inv_deg is not None else 0, dtype=torch.float32,
                          device=dev)
    with device_guard(dev):
        rc = _kernel()(*(None if t is None else t.data_ptr() for t in args),
                       scratch.data_ptr(), total.data_ptr(), n, num_src, int(warp_rows),
                       it.itemsize, dev.index, stream_handle(dev))
    if rc != 0:
        raise KernelLaunchError(f"pagerank gather-add kernel launch failed: cudaError {rc}")
    gather_add.launches += 1
    return total


gather_add.launches = 0
