"""Plain PageRank in float64: the reference the port's PageRank is held
against in the tests.

Plain ``torch`` operations only, nothing of ``locust_tpu`` or
``locust_tpu_torch``: from uniform ranks ``1 / n``, ``num_iters`` damped
power iterations over the arcs ``src[i] -> dst[i]`` as given (duplicate
arcs and self-loops each counted), the out-degrees counted from ``src``,
and the mass of the dangling nodes (out-degree 0) spread uniformly::

    r'[v] = (1 - d) / n + d * (sum over arcs u -> v of r[u] / deg[u]
                               + sum over dangling w of r[w] / n)

as LDBC Graphalytics defines PageRank.  The benchmark keeps its own
frozen copy (``benchmark/reference/pagerank.py``).
"""

from __future__ import annotations

import torch

# Arcs gathered and added per step, so a large graph's products fit.
CHUNK = 1 << 26


def pagerank(src: torch.Tensor, dst: torch.Tensor, num_nodes: int, num_iters: int = 20,
             damping: float = 0.85) -> torch.Tensor:
    """Float64 ranks ``[num_nodes]`` on ``src``'s device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src, dst = src.long(), dst.long()
    dev = src.device
    deg = torch.bincount(src, minlength=num_nodes).double()
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), torch.zeros_like(deg))
    dangling = deg == 0
    ranks = torch.full((num_nodes,), 1.0 / num_nodes, dtype=torch.float64, device=dev)
    for _ in range(num_iters):
        share = ranks * inv_deg
        total = torch.zeros(num_nodes, dtype=torch.float64, device=dev)
        for lo in range(0, src.shape[0], CHUNK):
            total.index_add_(0, dst[lo:lo + CHUNK], share[src[lo:lo + CHUNK]])
        mass = torch.where(dangling, ranks, 0.0).sum()
        ranks = (1.0 - damping) / num_nodes + damping * (total + mass / num_nodes)
    return ranks
