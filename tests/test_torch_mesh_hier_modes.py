"""PyTorch port, the hierarchical mesh engine under every sort mode: a
gloo world of 4 CPU processes as ``[2, 2]`` against the JAX package's
``HierarchicalMapReduce`` on ``make_mesh_2d(2, 2)`` (tests/torch_mesh_rig.py).
Host pairs byte for byte, the counters equal and the combined table bit
for bit.  JAX's CPU mesh sorts ``bitonic`` by its stock ``lax.sort`` and
demotes ``fused`` to hasht; the port's CPU ranks take the plain versions
and demote the same way."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import numpy as np
import pytest

import torch_mesh_rig as rig

from locust_tpu import parallel as jparallel
from locust_tpu.parallel.mesh import make_mesh_2d


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hier_modes_world"))
    procs = rig.start_world("torch", 4, out, "hier_modes")
    state = {"procs": procs, "out": out, "result": None}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("name", sorted(rig.HIER_MODES))
def test_every_sort_mode_equals_jax(world, name):
    want, want_table = rig.run_hier(rig.jax_pkg(), jparallel, make_mesh_2d, name)
    if world["result"] is None:
        world["result"] = rig.finish_world(world["procs"], world["out"], "torch")
    got = world["result"][name]
    for k in rig.STATS:
        assert got[k] == want[k], (name, k, got[k], want[k])
    assert got["pairs"] == want["pairs"]
    assert got["fused_demoted"] == (name == "hmode_fused")
    with np.load(f"{world['out']}/{name}.npz") as z:
        for k in ("key_lanes", "values", "valid"):
            assert np.array_equal(z[k], want_table[k]), (name, k)
