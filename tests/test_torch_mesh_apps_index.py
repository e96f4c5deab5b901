"""PyTorch port, the distributed inverted index
(``DistributedInvertedIndex``, ``build_inverted_index_mesh``) as a gloo
world of 2 CPU processes against the JAX package's on ``make_mesh(2)``,
on the corpora of tests/test_apps.py (tests/torch_mesh_rig.py): several
shuffle rounds against the Python oracle, tiny bins drained losslessly,
``run_stream == run``, the pair capacity's error and the dropped-postings
warning, each as JAX raises and logs it.  In this process, a world of one
against JAX's ``make_mesh(1)``: a checkpoint written by either package is
resumed by the other, both ways, and folds exactly the rounds after it."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import numpy as np
import pytest

import torch_mesh_rig as rig
from test_apps import py_inverted_index

from locust_tpu import apps as japps
from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.parallel.mesh import make_mesh as jmake_mesh
from locust_tpu_torch import apps as tapps
from locust_tpu_torch.config import EngineConfig as TConfig


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("index_world"))
    procs = rig.start_world("torch", 2, out, "apps_index")
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


@pytest.mark.parametrize("name", sorted(rig.INDEX))
def test_world_of_two_equals_jax(world, name):
    want = rig.run_index(japps, rig.jax_pkg(), jmake_mesh(2), name)
    got = _port(world)[f"index_{name}"]
    assert got == want


def test_scenarios_exercise_what_they_name(world):
    got = _port(world)
    for name in ("oracle", "skew"):
        kind, _ = rig.INDEX[name]
        oracle = {k.hex(): v for k, v in py_inverted_index(rig.index_docs(kind)).items()}
        assert got[f"index_{name}"]["index"] == oracle, name
    assert got["index_oracle"]["stream"] == got["index_oracle"]["index"]
    assert "pairs_capacity (4)" in got["index_capacity"]["error"]
    (warning,) = got["index_dropped"]["warnings"]
    assert "postings are MISSING" in warning


CK_CFG = {"block_lines": 4, "line_width": 64, "emits_per_line": 8}


def _index(pkg, mesh):
    cfg = (JConfig if pkg == "jax" else TConfig)(**CK_CFG)
    return (japps if pkg == "jax" else tapps).DistributedInvertedIndex(mesh, cfg)


def _crash(idx, lines, ids, ckpt, at=2):
    real, calls = idx._step, {"n": 0}

    def crashing(*a):
        if calls["n"] == at:
            raise RuntimeError("injected crash")
        calls["n"] += 1
        return real(*a)

    idx._step = crashing
    with pytest.raises(RuntimeError, match="injected crash"):
        idx.run(lines, ids, checkpoint_dir=ckpt, checkpoint_every=1, stats_sync_every=1)


def _resume(idx, lines, ids, ckpt):
    real, steps = idx._step, {"n": 0}

    def counting(*a):
        steps["n"] += 1
        return real(*a)

    idx._step = counting
    return idx.run(lines, ids, checkpoint_dir=ckpt, checkpoint_every=1), steps["n"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_checkpoint_resumes_across_packages(tmp_path, writer, reader):
    from locust_tpu_torch.parallel.mesh import make_mesh, shutdown

    docs = rig.index_docs("oracle")
    lines, ids = list(docs.values())[:40], np.arange(40, dtype=np.int32)
    meshes = {"jax": jmake_mesh(1), "torch": make_mesh(device="cpu")}
    try:
        ckpt = str(tmp_path / "ck")
        _crash(_index(writer, meshes[writer]), lines, ids, ckpt)
        got, steps = _resume(_index(reader, meshes[reader]), lines, ids, ckpt)
    finally:
        shutdown()
    assert got == py_inverted_index(dict(zip(range(40), lines)))
    # Snapshots every round and a crash before round 2: the other package
    # trusted the snapshot of round 2 and folded the 8 rounds after it.
    assert steps == 40 // CK_CFG["block_lines"] - 2
    assert (tmp_path / "ck" / "state.p0.npz").exists()
