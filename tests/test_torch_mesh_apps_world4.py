"""PyTorch port, the mesh apps as a gloo world of 4 CPU processes against
the JAX package's on ``make_mesh(4)`` (tests/torch_mesh_rig.py):
``ShardedPageRank`` on 1,003 nodes and on the dangling graph (most of the
four shards send nothing), ``DistributedPageRank`` on the skewed graph,
ranks bit for bit; the distributed index over several rounds and over
tiny bins; the sample sort of random and duplicate-heavy strings, with
the overflow at each skew factor equal to JAX's."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import numpy as np
import pytest

import torch_mesh_rig as rig

from locust_tpu import apps as japps
from locust_tpu.parallel.mesh import make_mesh as jmake_mesh

SUITE = rig.APP_SUITES["apps_world4"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("apps_world4"))
    procs = rig.start_world("torch", 4, out, "apps_world4")
    state = {"procs": procs, "out": out, "result": None}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _port(world):
    if world["result"] is None:
        world["result"] = rig.finish_world(world["procs"], world["out"], "torch")
    return world["result"]


@pytest.mark.parametrize("name", SUITE["pagerank"])
def test_pagerank_equals_jax(world, name):
    _port(world)
    with np.load(f"{world['out']}/{name}.npz") as z:
        got = z["ranks"]
    assert np.array_equal(got, rig.run_pagerank(japps, jmake_mesh(4), name))


@pytest.mark.parametrize("name", SUITE["index"])
def test_index_equals_jax(world, name):
    assert _port(world)[f"index_{name}"] == rig.run_index(japps, rig.jax_pkg(), jmake_mesh(4),
                                                          name)


@pytest.mark.parametrize("name", SUITE["sort"])
def test_sort_equals_jax(world, name):
    want = rig.run_sort(japps, rig.jax_pkg(), jmake_mesh(4), name)
    got = dict(_port(world)[f"sort_{name}"])
    if "pairs" in want:
        assert rig.sorted_runs(got.pop("pairs")) == rig.sorted_runs(want.pop("pairs"))
    assert got == want
