"""Graph500's Kronecker graph, made from the run's seed on the run's device.

The Graph500 specification's generator (its reference
``kronecker_generator.m``), in torch: ``M = edgefactor * 2**scale``
edges, each endpoint built one bit a level from the initiator
``A, B, C, D``::

    for ib in 0 .. scale - 1:
        ii = rand > A + B
        jj = rand > (C / (1 - A - B) if ii else A / (A + B))
        i += ii << ib;  j += jj << ib

then the vertex labels permuted by one random permutation of the
``2**scale`` vertices, and the edge list shuffled by one of the ``M``
edges.  Self-loops and duplicate edges stay as generated.  The graph is
undirected: ``kronecker_arcs`` gives each edge as two arcs, the shuffled
edges' ``u -> v`` arcs, then their ``v -> u`` arcs.  Edges are made in
chunks, so the device holds the bits of one chunk at a time; the same
seed on the same device gives the same graph.
"""

from __future__ import annotations

import numpy as np

from benchmark import harness

# Edges whose endpoint bits are drawn at once.
CHUNK = 1 << 24
# Tells the generator's seed apart from any other stream of the run.
STREAM = 500


def torch_seed(seed: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from the run's seed."""
    rng = np.random.default_rng(harness.seed_words(seed, STREAM))
    return int(rng.integers(0, 2**63 - 1))


def kronecker_edges(scale: int, edgefactor: int, initiator, seed: int, device: str = "cuda"):
    """The ``(u, v)`` int64 columns of the ``edgefactor * 2**scale``
    shuffled edges over ``2**scale`` permuted vertices, on ``device``."""
    import torch

    a, b, c = (float(x) for x in initiator[:3])
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    n, m = 1 << scale, edgefactor << scale
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(torch_seed(seed))
    u = torch.empty(m, dtype=torch.int64, device=dev)
    v = torch.empty(m, dtype=torch.int64, device=dev)
    for lo in range(0, m, CHUNK):
        k = min(CHUNK, m - lo)
        i = torch.zeros(k, dtype=torch.int64, device=dev)
        j = torch.zeros(k, dtype=torch.int64, device=dev)
        for ib in range(scale):
            ii = torch.rand(k, generator=gen, device=dev) > ab
            jj = torch.rand(k, generator=gen, device=dev) > a_norm + (c_norm - a_norm) * ii
            i += ii.long() << ib
            j += jj.long() << ib
        u[lo:lo + k] = i
        v[lo:lo + k] = j
    label = torch.randperm(n, generator=gen, device=dev)
    u, v = label[u], label[v]
    order = torch.randperm(m, generator=gen, device=dev)
    return u[order], v[order]


def kronecker_arcs(graph: dict, seed: int, device: str = "cuda"):
    """The arcs of the configuration's ``graph`` section, both directions
    of every edge: ``src``, ``dst`` int64, the ``u -> v`` arcs, then the
    ``v -> u`` arcs."""
    import torch

    u, v = kronecker_edges(graph["scale"], graph["edgefactor"], graph["initiator"], seed,
                           device)
    return torch.cat([u, v]), torch.cat([v, u])


def facts(src, dst, num_nodes: int, warp_row_edges: int = 64) -> dict:
    """The graph's shape as the benchmark counts it from its own arrays:
    nodes, arcs, isolated nodes (no arc in or out), the largest in-degree
    and the rows of more than ``warp_row_edges`` in-arcs."""
    import torch

    indeg = torch.bincount(dst, minlength=num_nodes)
    touched = indeg + torch.bincount(src, minlength=num_nodes)
    return {"nodes": num_nodes, "arcs": int(src.shape[0]),
            "isolated": int((touched == 0).sum()), "max_in_degree": int(indeg.max()),
            "warp_rows": int((indeg > warp_row_edges).sum())}
