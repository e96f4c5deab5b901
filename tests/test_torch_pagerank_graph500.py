"""PyTorch port, PageRank over Graph500 Kronecker graphs through the plan
path, ``compile_plan(pagerank_plan()).run((src, dst), num_nodes=n)``, on
the CPU: the ranks against the plain float64 reference
(tests/plain_pagerank.py) on seeded graphs of SCALE 8-11 whose hubs take
thousands of in-arcs (rows far past the kernel's 64-arc warp rows);
tensor and numpy edge sources bit for bit, single-device and on a mesh
of one; the node count read from tensors; and the job's spans and
iteration counter with the tracer on, and nothing recorded with it
off."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import collections

import numpy as np
import pytest
import torch

import plain_pagerank
from locust_tpu_torch import obs
from locust_tpu_torch.ops.kernels.pagerank import WARP_ROW_THRESHOLD
from locust_tpu_torch.plan import pagerank_plan
from locust_tpu_torch.plan.compile import compile_plan

ITERS, DAMPING = 20, 0.85
# Float32 against float64: a node's rank is a left fold of at most the
# largest in-degree ``dmax`` float32 adds a step, each rounded to within
# 2^-24 of the partial sum; rounding errors of a long fold add like a
# random walk, ~sqrt(dmax) * 2^-24, and the 20 steps' errors add up.  So
# no node's relative error may pass 20 * sqrt(dmax) * 2^-24 (7.5e-5 at
# SCALE 11; the port reads 7e-7 to 4e-6).  The ranks sum to 1, so the L1
# error is at most that relative bound too.
STEPS_ERR = ITERS * 2.0**-24

GRAPHS = [(8, 11), (9, 2**33 + 9), (10, 5), (11, 3_000_000_007)]


def kronecker(scale: int, seed: int, edgefactor: int = 16, abc=(0.57, 0.19, 0.19)):
    """Graph500's Kronecker generator (the specification's
    ``kronecker_generator.m``) in numpy: one bit a level per endpoint,
    the vertices permuted, the edges shuffled; both arcs of every edge,
    the ``u -> v`` arcs first.  int64 ``(src, dst)``."""
    rng = np.random.default_rng(seed)
    a, b, c = abc
    m = edgefactor << scale
    i = np.zeros(m, np.int64)
    j = np.zeros(m, np.int64)
    for ib in range(scale):
        ii = rng.random(m) > a + b
        jj = rng.random(m) > np.where(ii, c / (1 - a - b), a / (a + b))
        i += ii.astype(np.int64) << ib
        j += jj.astype(np.int64) << ib
    label = rng.permutation(1 << scale)
    order = rng.permutation(m)
    u, v = label[i][order], label[j][order]
    return np.concatenate([u, v]), np.concatenate([v, u])


def plan_ranks(src, dst, num_nodes=None, iters=ITERS, mesh=False) -> np.ndarray:
    cp = compile_plan(pagerank_plan(num_iters=iters, damping=DAMPING), mesh=mesh, device="cpu")
    return cp.run((src, dst), num_nodes=num_nodes, render=False).value


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.disable()
    yield
    obs.disable()


@pytest.mark.parametrize("scale,seed", GRAPHS)
def test_plan_path_on_the_kronecker_graph_matches_the_plain_reference(scale, seed):
    src, dst = kronecker(scale, seed)
    n = 1 << scale
    dmax = int(np.bincount(dst, minlength=n).max())
    assert dmax > 10 * WARP_ROW_THRESHOLD  # the hubs' rows are long
    got = plan_ranks(torch.from_numpy(src), torch.from_numpy(dst), n)
    want = plain_pagerank.pagerank(torch.from_numpy(src), torch.from_numpy(dst), n, ITERS,
                                   DAMPING).numpy()
    assert got.dtype == np.float32 and got.shape == (n,) and np.isfinite(got).all()
    bound = STEPS_ERR * np.sqrt(dmax)
    err = np.abs(got.astype(np.float64) - want)
    assert (err / want).max() <= bound
    assert err.sum() <= bound
    assert abs(want.sum() - 1.0) < 1e-12  # the reference loses no mass


@pytest.mark.parametrize("num_nodes", [None, "n"])
@pytest.mark.parametrize("scale,seed", GRAPHS[:2])
def test_tensor_and_numpy_edge_sources_give_the_same_bits(scale, seed, num_nodes):
    src, dst = kronecker(scale, seed)
    n = (1 << scale) if num_nodes == "n" else None
    from_numpy = plan_ranks(src, dst, n)
    from_tensors = plan_ranks(torch.from_numpy(src), torch.from_numpy(dst), n)
    assert from_numpy.dtype == from_tensors.dtype == np.float32
    assert np.array_equal(from_numpy, from_tensors)


def test_node_count_read_from_tensors_equals_numpys():
    """A graph whose largest ids are isolated: the count is the largest id
    on either side, plus one, from tensors as from numpy arrays."""
    src, dst = kronecker(9, 78)
    top = int(max(src.max(), dst.max()))
    assert top < (1 << 9) - 1  # the largest ids of the label space touch no arc
    got = plan_ranks(torch.from_numpy(src), torch.from_numpy(dst))
    want = plan_ranks(src, dst)
    assert got.shape == want.shape == (top + 1,)
    assert np.array_equal(got, want)


def test_mesh_lowering_takes_tensor_edges():
    """Under ``mesh=True`` (a world of one, in this process) tensors give
    the numpy arrays' ranks."""
    from locust_tpu_torch.parallel.mesh import shutdown

    src, dst = kronecker(8, 3)
    try:
        want = plan_ranks(src, dst, 1 << 8, mesh=True)
        got = plan_ranks(torch.from_numpy(src), torch.from_numpy(dst), 1 << 8, mesh=True)
    finally:
        shutdown()
    assert np.array_equal(got, want)


def _recorded(tracer) -> collections.Counter:
    return collections.Counter(name for name, *_ in tracer.spans())


@pytest.mark.parametrize("iters", [1, 7])
def test_tracer_on_records_the_job_spans_and_iterations(iters):
    src, dst = kronecker(8, 11)
    tracer = obs.enable(process="unit")
    plan_ranks(torch.from_numpy(src), torch.from_numpy(dst), 1 << 8, iters=iters)
    names = _recorded(tracer)
    assert names["pagerank.prep"] == 1 and names["pagerank.grouping"] == 1
    assert names["pagerank.iteration"] == iters
    assert obs.metrics_snapshot()["counters"]["pagerank.iterations"] == iters
    parents = {name: args.get("parent") for name, _, _, _, args in tracer.spans()
               if name.startswith("pagerank.")}
    assert set(parents.values()) == {"plan.run"}
    t = {}
    for name, a, b, _, _ in tracer.spans():
        t.setdefault(name, (a, b))  # the first of each
    assert t["pagerank.prep"][1] <= t["pagerank.grouping"][0]
    assert t["pagerank.grouping"][1] <= t["pagerank.iteration"][0]


def test_tracer_off_records_nothing():
    """Masked off on this thread, an enabled tracer records no span and no
    count of the job; with telemetry disabled, none exists to record."""
    src, dst = kronecker(8, 11)
    tracer = obs.enable(process="unit")
    with obs.scoped(None):
        plan_ranks(torch.from_numpy(src), torch.from_numpy(dst), 1 << 8, iters=3)
    assert not tracer.spans()
    assert "pagerank.iterations" not in obs.metrics_snapshot().get("counters", {})
    obs.disable()
    plan_ranks(torch.from_numpy(src), torch.from_numpy(dst), 1 << 8, iters=3)
    assert obs.current() is None and obs.metrics_snapshot() == {}
