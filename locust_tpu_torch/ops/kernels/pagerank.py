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

``in_edges`` groups the edges by destination with a stable sort (the CSR
offsets and the sources in that order); it is loop-invariant, built once
per graph.  ``gather_add`` launches the kernel for a CUDA tensor (and
counts it in ``gather_add.launches``) and takes the plain version,
``index_add_`` over the grouped edges, only for a CPU tensor.
``csr_walk_reference`` is the same walk as torch ops, in order on any
device: the card check holds the kernel against it bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from locust_tpu_torch import _build
from locust_tpu_torch.ops.kernels import KernelLaunchError
from locust_tpu_torch.ops.kernels.tokenize import device_guard, stream_handle


def in_edges(dst: torch.Tensor, num_nodes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(offsets, order)``: int64 CSR offsets ``[num_nodes + 1]`` of the
    edges grouped by destination, and ``order`` ``[E]``, the edge indices
    in that grouping, edge order kept within each group (a stable sort)."""
    d = dst.to(torch.int64)
    order = torch.sort(d, stable=True).indices
    counts = torch.bincount(d, minlength=num_nodes)
    offsets = torch.zeros(num_nodes + 1, dtype=torch.int64, device=d.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return offsets, order


def csr_walk_reference(init: torch.Tensor, offsets: torch.Tensor, src_by_dst: torch.Tensor,
                       ranks: torch.Tensor, inv_deg: torch.Tensor) -> torch.Tensor:
    """Plain version as explicit adds in order, on any device: the nodes
    sorted by in-degree, step ``j`` adds every node's ``j``-th contribution
    (the nodes with more than ``j`` in-edges are a prefix)."""
    n = offsets.shape[0] - 1
    contrib = ranks[src_by_dst] * inv_deg[src_by_dst]
    deg = offsets[1:] - offsets[:-1]
    by_deg = torch.sort(deg, descending=True, stable=True).indices
    start, deg_sorted = offsets[:-1][by_deg], deg[by_deg]
    acc = init.to(torch.float32).expand(n).clone()
    for j in range(int(deg_sorted[0]) if n else 0):
        live = int((deg_sorted > j).sum())
        nodes = by_deg[:live]
        acc[nodes] = acc[nodes] + contrib[start[:live] + j]
    return acc


def _plain(init, offsets, src_by_dst, ranks, inv_deg) -> torch.Tensor:
    """Plain version for a CPU tensor: ``index_add_`` in the grouping's
    order (the CPU adds in index order)."""
    n = offsets.shape[0] - 1
    dst_sorted = torch.repeat_interleave(torch.arange(n), offsets[1:] - offsets[:-1])
    return init.expand(n).clone().index_add_(
        0, dst_sorted, ranks[src_by_dst] * inv_deg[src_by_dst])


@functools.cache
def _kernel():
    fn = _build.load("pagerank").locust_pagerank_gather_add
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int
    return fn


def gather_add(init: torch.Tensor, offsets: torch.Tensor, src_by_dst: torch.Tensor,
               ranks: torch.Tensor, inv_deg: torch.Tensor) -> torch.Tensor:
    """``total[v] = init + sum of v's contributions in edge order``:
    float32 ``[num_nodes]`` on ``ranks``'s device.  ``init`` is a float32
    scalar tensor, ``offsets``/``src_by_dst`` the int64 grouping of
    ``in_edges`` (sources, not edge indices), ``ranks``/``inv_deg``
    float32 ``[num_nodes]``."""
    dev = ranks.device
    if dev.type == "cpu":
        return _plain(init, offsets, src_by_dst, ranks, inv_deg)
    if dev.type != "cuda":
        raise ValueError(f"pagerank gather-add: no kernel for device {dev}")
    n = offsets.shape[0] - 1
    args = [init.reshape(1), offsets, src_by_dst, ranks, inv_deg]
    for name, t, dtype in zip(("init", "offsets", "src_by_dst", "ranks", "inv_deg"), args,
                              (torch.float32, torch.int64, torch.int64, torch.float32,
                               torch.float32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"pagerank gather-add: {name} must be a contiguous {dtype} "
                             f"tensor on {dev}")
    if ranks.shape[0] != n or inv_deg.shape[0] != n:
        raise ValueError("pagerank gather-add: ranks and inv_deg must have num_nodes rows")
    total = torch.empty(n, dtype=torch.float32, device=dev)
    with device_guard(dev):
        rc = _kernel()(*(t.data_ptr() for t in args), total.data_ptr(), n, stream_handle(dev))
    if rc != 0:
        raise KernelLaunchError(f"pagerank gather-add kernel launch failed: cudaError {rc}")
    gather_add.launches += 1
    return total


gather_add.launches = 0
