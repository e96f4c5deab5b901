"""PyTorch port, PageRank (``locust_tpu_torch.apps.pagerank``) against the
JAX package on the CPU: ``pagerank``, ``pagerank_prep`` and
``pagerank_step`` on seeded graphs of up to 2,000 nodes with dangling
nodes, to rtol 1e-6 and, since the port adds in XLA's CPU order, bit
for bit; the XLA-order sum alone; and the edge-list parser's errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.apps.pagerank import pagerank as jpagerank
from locust_tpu.apps.pagerank import pagerank_prep as jprep
from locust_tpu.apps.pagerank import pagerank_step as jstep
from locust_tpu.plan import PlanError as JPlanError
from locust_tpu.plan.compile import edges_from_bytes as jedges
from locust_tpu_torch.apps.pagerank import _xla_sum, pagerank, pagerank_prep, pagerank_step
from locust_tpu_torch.plan import PlanError
from locust_tpu_torch.plan.compile import edges_from_bytes


def _graph(seed: int, n: int, e: int):
    """Seeded skewed graph; every 7th source id folds onto node 3, so the
    graph has dangling nodes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (rng.zipf(1.5, e) % n).astype(np.int32)
    src[src % 7 == 0] = 3
    return src, dst


GRAPHS = [(0, 2000, 9000), (1, 7, 9), (2, 1999, 20000), (3, 33, 100), (4, 500, 800)]


@pytest.mark.parametrize("seed,n,e", GRAPHS)
@pytest.mark.parametrize("iters,damping", [(20, 0.85), (7, 0.5)])
def test_pagerank_equals_jax(seed, n, e, iters, damping):
    src, dst = _graph(seed, n, e)
    want = np.asarray(jpagerank(src, dst, num_nodes=n, num_iters=iters, damping=damping))
    got = pagerank(src, dst, n, iters, damping, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.array_equal(got, want)  # the same adds in the same order


@pytest.mark.parametrize("seed,n,e", GRAPHS[:3])
def test_prep_and_step_equal_jax(seed, n, e):
    src, dst = _graph(seed, n, e)
    ranks = np.random.default_rng(seed).random(n).astype(np.float32) / n
    j_inv, j_dang = jprep(src, n)
    t_inv, t_dang = pagerank_prep(src, n, device="cpu")
    assert np.array_equal(t_inv.numpy(), np.asarray(j_inv))
    assert np.array_equal(t_dang.numpy(), np.asarray(j_dang))
    want = np.asarray(jstep(src, dst, ranks, j_inv, j_dang, 0.85, n))
    got = pagerank_step(src, dst, torch.from_numpy(ranks), t_inv, t_dang,
                        torch.tensor(0.85), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 1024, 1025, 32769, 100_000])
def test_xla_order_sum_equals_jnp_sum(n):
    x = (np.random.default_rng(n).random(n).astype(np.float32) / n) * 3
    want = np.float32(jax.jit(jnp.sum)(x))
    assert np.float32(_xla_sum(torch.from_numpy(x))) == want


@pytest.mark.parametrize("corpus", [
    b"0 1 2\n", b"# only a comment\n", b"", b"0 x\n", b"0 -1\n", b"1 0\n3\n",
])
def test_edge_parser_errors_equal_jax(corpus):
    with pytest.raises(JPlanError) as theirs:
        jedges(corpus)
    with pytest.raises(PlanError) as ours:
        edges_from_bytes(corpus)
    assert str(ours.value) == str(theirs.value)


def test_edge_parser_equals_jax():
    corpus = b"# SNAP header\n0 1\n\n 1\t2 \n2 0\r\n7 3\n"
    (js, jd), (ts, td) = jedges(corpus), edges_from_bytes(corpus)
    assert js.tolist() == ts.tolist() and jd.tolist() == td.tolist()
    assert ts.dtype == np.int64


def test_pagerank_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = _graph(0, 7, 9)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pagerank(src, dst, 7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pagerank_prep(src, 7)
