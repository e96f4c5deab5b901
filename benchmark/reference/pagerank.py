"""PageRank as LDBC Graphalytics defines it, in plain ``torch`` and float64,
and the comparison of an answer with it.

Frozen copy of the repository's test reference (``tests/plain_pagerank.py``);
nothing of the port or of JAX.  From uniform ranks ``1 / n``,
``num_iters`` damped power iterations over the arcs ``src[i] -> dst[i]``
as given (duplicate arcs and self-loops each counted), the out-degrees
counted from ``src``, and the mass of the dangling nodes (out-degree 0)
spread uniformly::

    r'[v] = (1 - d) / n + d * (sum over arcs u -> v of r[u] / deg[u]
                               + sum over dangling w of r[w] / n)

It runs on the device of the arcs it is given, ``CHUNK`` arcs a step, so
on the card after the program's state is freed.
"""

from __future__ import annotations

import numpy as np
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


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """An answer's ranks against the reference's, both host arrays:
    ``rank_rel_err_max`` (the largest ``|got - want| / want``) and
    ``rank_l1_err`` (the sum of ``|got - want|``) over the finite ranks,
    and ``nonfinite_ranks``, where a node missing from the answer counts
    as a non-finite rank."""
    want = np.asarray(want, np.float64)
    full = np.full(want.shape, np.nan)
    got = np.asarray(got, np.float64).ravel()[:want.size]
    full[:got.size] = got
    ok = np.isfinite(full)
    err = np.abs(full[ok] - want[ok])
    return {"rank_rel_err_max": float((err / want[ok]).max(initial=0.0)),
            "rank_l1_err": float(err.sum()),
            "nonfinite_ranks": int(want.size - ok.sum())}
