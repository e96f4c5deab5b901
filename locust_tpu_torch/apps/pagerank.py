"""PageRank: iterative MapReduce over an edge list.

Port of the single-device part of ``locust_tpu/apps/pagerank.py``
(``DistributedPageRank`` and ``ShardedPageRank`` wait for the mesh apps,
queue item 9c; the flat and hierarchical mesh engines are in
``locust_tpu_torch.parallel``).  Per iteration, map each edge (s -> d) to the emit
``(d, rank[s]/deg[s])`` and reduce by key with sum, then apply damping.
Node ids ARE the keys, so the shuffle degenerates to a dense segment sum
into a ``[num_nodes]`` vector — no byte keys, no sort.
Dangling mass (deg == 0 nodes) redistributes uniformly.

Ranks are float32, and the port adds in the order the JAX package's
CPU compile adds, so that on the CPU the ranks are the same bits:

  * the dangling mass is summed as XLA's CPU reduction does
    (``_xla_sum``: windows of 32, each summed in order, the input padded
    with zeros split evenly on both ends, repeated until 32 or fewer
    partial sums remain, which are then summed in order);
  * ``x / num_nodes`` is ``x * f32(1 / num_nodes)``, XLA's rewrite of a
    division by a constant;
  * the contributions are added in edge order onto the dangling share
    ``mass / num_nodes`` (XLA folds that addend into the scatter's
    initial value): ``ops/kernels/pagerank.gather_add`` walks each node's
    in-edges, grouped once per graph into one row per node by a stable
    sort (``pagerank_grouping``), in edge order, each product rounded to
    float32 before its add; on the CPU it
    is ``index_add_``, which adds in index order, and on CUDA the
    gather-add kernel (``csrc/pagerank.cu``), so the card's ranks are the
    CPU's bits too;
  * ``teleport + damping * s`` is one rounding of the exact value, as the
    fused multiply-add XLA's CPU compile emits: the port computes it in
    float64 (the product is exact) and rounds to float32.
"""

from __future__ import annotations

import numpy as np
import torch

from locust_tpu_torch.engine import resolve_device
from locust_tpu_torch.ops.kernels.pagerank import Grouping, gather_add, in_edges

# XLA's CPU compile reduces in windows of this many elements.
_XLA_REDUCE_WINDOW = 32


def _xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum a float32 vector in the order of XLA's CPU reduction: explicit
    elementwise adds, so the order is the same on any device."""
    w = _XLA_REDUCE_WINDOW
    while x.shape[0] > w:
        n = x.shape[0]
        pad = -(-n // w) * w - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(-1, w)
        acc = x[:, 0]
        for j in range(1, w):
            acc = acc + x[:, j]
        x = acc
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for j in range(x.shape[0]):
        acc = acc + x[j]
    return acc


def _edges(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=torch.int64)


def pagerank_prep(src, num_nodes: int, device=None):
    """The loop-invariant state of ``pagerank``: ``(inv_deg, dangling)``
    from the FULL edge source column."""
    dev = resolve_device(device)
    s = _edges(src, dev)
    deg = torch.zeros(num_nodes, dtype=torch.float32, device=dev).index_add_(
        0, s, torch.ones(s.shape[0], dtype=torch.float32, device=dev)
    )
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), zero)
    return inv_deg, deg == 0


def pagerank_grouping(src, dst, num_nodes: int, device=None) -> Grouping:
    """The loop-invariant in-edge grouping ``pagerank_step`` walks
    (``ops/kernels/pagerank.in_edges``): one row per node, in a schedule
    of the nodes by in-degree, largest first, each row its in-edges'
    sources in edge order (a stable sort), with the rows' CSR offsets
    and how many of them take a warp each."""
    dev = resolve_device(device)
    return in_edges(_edges(src, dev), _edges(dst, dev), num_nodes)


def pagerank_step(src, dst, ranks: torch.Tensor, inv_deg: torch.Tensor,
                  dangling: torch.Tensor, damping, num_nodes: int,
                  grouping=None) -> torch.Tensor:
    """ONE ``pagerank`` iteration, on ``ranks``'s device.  ``damping`` is
    a float32 operand, never a Python float: ``(1 - damping) / n`` is
    computed in float32, as the JAX package's traced operand is (a
    float64 constant would change the low bits).  ``grouping`` is
    ``pagerank_grouping(src, dst, num_nodes)``, built here when None."""
    dev = ranks.device
    if grouping is None:
        grouping = pagerank_grouping(src, dst, num_nodes, dev)
    damping = torch.as_tensor(damping, dtype=torch.float32).to(dev)
    inv_n = torch.tensor(np.float32(1) / np.float32(num_nodes), device=dev)
    teleport = (1.0 - damping) * inv_n
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mass = _xla_sum(torch.where(dangling, ranks, zero))
    total = gather_add(mass * inv_n, *grouping, ranks.contiguous(), inv_deg)
    return (teleport.double() + damping.double() * total.double()).float()


def pagerank(src, dst, num_nodes: int, num_iters: int = 20,
             damping: float = 0.85, device=None) -> torch.Tensor:
    """Single-device PageRank over edge arrays ``[E]`` (numpy or tensors):
    ``num_iters`` damped power iterations from uniform ranks; float32
    ranks ``[num_nodes]`` on the device.  Pass valid edges only (no
    padding).  Runs on CUDA unless ``device`` says otherwise."""
    dev = resolve_device(device)
    s, d = _edges(src, dev), _edges(dst, dev)
    inv_deg, dangling = pagerank_prep(s, num_nodes, dev)
    grouping = pagerank_grouping(s, d, num_nodes, dev)
    damping = torch.tensor(damping, dtype=torch.float32, device=dev)
    ranks = torch.full((num_nodes,), 1.0 / num_nodes, dtype=torch.float32, device=dev)
    for _ in range(num_iters):
        ranks = pagerank_step(s, d, ranks, inv_deg, dangling, damping, num_nodes, grouping)
    return ranks
