"""PyTorch port, the hierarchical mesh engine as a gloo world of 4 CPU
processes against the JAX package's ``HierarchicalMapReduce`` on
``make_mesh_2d`` over the same number of virtual devices: the
``[2, 2]``, ``[4, 1]`` and ``[1, 4]`` layouts, drained bins, a key in
every slice, ``count``, a truncated combine (tests/test_hierarchical.py's
cases; every sort mode is in tests/test_torch_mesh_hier_modes.py).  Host pairs byte for byte, the counters equal, and the combined
table bit for bit.  The same world also runs ``run_stream == run``, a
crash and resume of the hierarchical engine and of the flat one over 4
processes (tests/test_multiprocess.py::test_four_process_checkpoint_resume),
``LOCUST_DEBUG_CHECKS``' slice-replication check (passing, then firing
on a doctored slice) and the mesh shape errors."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os

import numpy as np
import pytest

import torch_mesh_rig as rig
from helpers import py_wordcount

from locust_tpu import parallel as jparallel
from locust_tpu.parallel.mesh import make_mesh_2d


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hier_world"))
    procs = rig.start_world("torch", 4, out, "hier")
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


def _oracle(kind, emits=rig.CFG["emits_per_line"]):
    return {k.hex(): v for k, v in py_wordcount(rig.lines_of(kind), emits).items()}


@pytest.mark.parametrize("name", sorted(rig.HIER))
def test_world_of_four_equals_jax(world, name):
    want, want_table = rig.run_hier(rig.jax_pkg(), jparallel, make_mesh_2d, name)
    got = _port(world)[name]
    for k in rig.STATS:
        assert got[k] == want[k], (name, k, got[k], want[k])
    assert got["pairs"] == want["pairs"]
    _, kind, cfg_kw, _ = rig.HIER[name]
    if not got["truncated"]:
        assert dict(map(tuple, got["pairs"])) == _oracle(
            kind, cfg_kw.get("emits_per_line", rig.CFG["emits_per_line"]))
    with np.load(f"{world['out']}/{name}.npz") as z:
        for k in ("key_lanes", "values", "valid"):
            assert np.array_equal(z[k], want_table[k]), (name, k)


def test_scenarios_exercise_what_they_name(world):
    got = _port(world)
    assert got["h2x2_skew"]["drain_rounds"] > 0 and got["h2x2_trunc"]["truncated"]
    assert got["h2x2_same"]["distinct"] == 1
    assert got["h2x2_count"]["pairs"] == [[b"same".hex(), 3 * 256]]


def test_run_stream_equals_run(world):
    assert _port(world)["hstream"] == _port(world)["h2x2"]["pairs"]


@pytest.mark.parametrize("name,ckpt", [("hcrash", "ckpt_hier"), ("crash4", "ckpt_flat4")])
def test_four_process_crash_and_resume(world, name, ckpt):
    got = _port(world)[name]
    assert dict(map(tuple, got["pairs"])) == _oracle("resume")
    assert got["resumed_rounds"] == got["nrounds"] - 2
    assert got["third_run_steps"] == 0 and got["third_run_same"]
    for pid in range(4):
        assert os.path.exists(f"{world['out']}/{ckpt}/state.p{pid}.npz")


def test_debug_checks_police_slice_replication(world):
    got = _port(world)
    assert got["debug_healthy"] == got["h2x2"]["pairs"]
    assert "slice-varying 'values'" in got["debug_doctored"]


def test_mesh_shape_errors(world):
    got = _port(world)
    assert "do not divide into 3 slices" in got["mesh_error_3"]
    assert "requested 16 devices, have 4" in got["mesh_error_4"]
    assert "mesh must have axes" in got["axes_error"]
