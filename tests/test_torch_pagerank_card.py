"""PyTorch port, PageRank's gather-add kernel (``csrc/pagerank.cu``) on a
card against the CPU wrapper (``index_add_`` over the grouped edges, in
edge order), bit for bit, on a Graph500 Kronecker graph of SCALE 18
(262,144 nodes, 8,388,608 arcs, hubs of thousands of in-arcs): weighted
and unweighted, int32 and int64 indices, and sources and rows in one
index space or two (``num_src != num_nodes``, as the sharded PageRank's
sums have).

The tests need a CUDA card and skip without one; on the card run
``python -m pytest --noconftest tests/test_torch_pagerank_card.py`` (the
suite's conftest imports JAX, which the card's machine lacks)."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import functools

import numpy as np
import pytest
import torch

from locust_tpu_torch.apps.pagerank import pagerank_prep
from locust_tpu_torch.ops.kernels.pagerank import WARP_ROW_THRESHOLD, gather_add, in_edges
from test_torch_pagerank_graph500 import kronecker

SCALE = 18


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gather-add kernel runs there")
    return torch.device("cuda")


@functools.cache
def _graph():
    src, dst = kronecker(SCALE, seed=2_000_000_019)
    return torch.from_numpy(src), torch.from_numpy(dst)


@pytest.mark.cuda
@pytest.mark.parametrize("spaces", ["one", "two"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("weighted", [True, False])
def test_card_gather_add_equals_the_cpu_wrapper(card, weighted, dtype, spaces):
    n = 1 << SCALE
    src, dst = _graph()
    # Two spaces: the rows fold onto a third of the nodes, the sources
    # stay every node.
    rows = n if spaces == "one" else n // 3
    dst = dst % rows
    rng = np.random.default_rng(SCALE)
    ranks = torch.from_numpy(rng.random(n).astype(np.float32) / n)
    inv_deg = pagerank_prep(src, n, device="cpu")[0] if weighted else None
    init = torch.tensor(np.float32(0.15) / np.float32(n))
    g_cpu = in_edges(src, dst, rows, dtype=dtype, num_src=n)
    g_card = in_edges(src.to(card), dst.to(card), rows, dtype=dtype, num_src=n)
    assert g_card.warp_rows == g_cpu.warp_rows > 0
    assert int(g_cpu.offsets[1]) > 500 * WARP_ROW_THRESHOLD  # the hub: ~230 groups
    want = gather_add(init, *g_cpu, ranks, inv_deg)
    got = gather_add(init.to(card), *g_card, ranks.to(card),
                     None if inv_deg is None else inv_deg.to(card))
    assert got.shape == (rows,) and torch.equal(got.cpu(), want)
