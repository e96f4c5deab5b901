"""PyTorch port, PageRank on the mesh (``ShardedPageRank``,
``DistributedPageRank``) as a gloo world of 2 CPU processes against the
JAX package's on ``make_mesh(2)`` (its virtual CPU mesh), on the same
seeded graphs (tests/torch_mesh_rig.py): 64, 1,000 and 1,003 nodes, the
dangling and empty-shard graph of tests/test_apps.py and a skewed one.

The ranks must be the same bits (``np.array_equal``): the port's two
gather-adds add in edge order as XLA's CPU scatter does, and it folds
the ranks' partials and dangling masses in the order JAX's CPU ``psum``
adds, which the first test here finds.  ``_build_plan``'s arrays equal
JAX's for worlds of 1 to 8, and a world of one equals JAX's
``make_mesh(1)`` in this process."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_mesh_rig as rig

from locust_tpu import apps as japps
from locust_tpu.parallel.mesh import compat_shard_map
from locust_tpu.parallel.mesh import make_mesh as jmake_mesh
from locust_tpu_torch import apps as tapps
from locust_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pagerank_world"))
    procs = rig.start_world("torch", 2, out, "apps_pagerank")
    state = {"procs": procs, "out": out, "result": None}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _port(world, name):
    if world["result"] is None:
        world["result"] = rig.finish_world(world["procs"], world["out"], "torch")
    with np.load(f"{world['out']}/{name}.npz") as z:
        return z["ranks"]


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_jax_cpu_psum_adds_left_to_right_in_rank_order(n):
    """The order the port folds the gathered partials in: JAX's CPU psum
    of float32 values over ``n`` devices is ((x0 + x1) + x2) + ...; values
    across eight decades make every other order differ somewhere."""
    rng = np.random.default_rng(n)
    x = (rng.random((n, 4096)) * 10.0 ** rng.integers(-8, 8, (n, 4096))).astype(np.float32)
    psum = jax.jit(compat_shard_map(lambda v: jax.lax.psum(v, "data"), mesh=jmake_mesh(n),
                                    in_specs=(P("data"),), out_specs=P()))
    got = np.asarray(psum(x.reshape(-1)))
    left = x[0]
    for row in x[1:]:
        left = left + row
    assert np.array_equal(got, left)
    if n > 2:
        right = x[-1]
        for row in x[-2::-1]:
            right = row + right
        assert not np.array_equal(got, right)


@pytest.mark.parametrize("name", sorted(rig.PAGERANK))
def test_world_of_two_equals_jax(world, name):
    want = rig.run_pagerank(japps, jmake_mesh(2), name)
    got = _port(world, name)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.array_equal(got, want)  # the same adds in the same order


def test_dangling_graph_conserves_mass(world):
    got = _port(world, "sharded_dangling")
    assert abs(float(got.sum()) - 1.0) < 1e-3


class _Mesh(tmesh.Mesh):
    """A mesh of ``n`` ranks for the host-side plan alone (no collective)."""

    def __init__(self, n):
        super().__init__(0, n, ("data",), (n,), {"data": None}, None, "gloo")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("graph", ["g64", "g1003", "dangling", "zipf"])
def test_build_plan_equals_jax(n, graph):
    num, src, dst = rig.pr_graph(graph)
    want = japps.ShardedPageRank(jmake_mesh(n), num)._build_plan(src, dst)
    got = tapps.ShardedPageRank(_Mesh(n), num)._build_plan(src, dst)
    assert got.keys() == want.keys()
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_world_of_one_in_process_equals_jax():
    from locust_tpu_torch.parallel.mesh import make_mesh, shutdown

    mesh = make_mesh(device="cpu")
    try:
        for name in ("sharded_1003", "sharded_dangling", "distributed_zipf"):
            want = rig.run_pagerank(japps, jmake_mesh(1), name)
            assert np.array_equal(rig.run_pagerank(tapps, mesh, name), want), name
    finally:
        shutdown()


def test_mesh_apps_shard_over_the_whole_world():
    """A rank is a process: the apps shard over every rank of the world,
    and refuse an axis that spans only part of it."""
    two_by_two = tmesh.Mesh(0, 4, ("slice", "data"), (2, 2), {}, None, "gloo")
    for cls in (tapps.ShardedPageRank, tapps.DistributedPageRank):
        with pytest.raises(ValueError, match="whole world"):
            cls(two_by_two, 10)
    with pytest.raises(ValueError) as theirs:
        japps.ShardedPageRank(jmake_mesh(2), 0)
    with pytest.raises(ValueError) as ours:
        tapps.ShardedPageRank(_Mesh(2), 0)
    assert str(ours.value) == str(theirs.value)
