"""PyTorch port, the flat mesh engine (``locust_tpu_torch.parallel``) as a
gloo world of 2 CPU processes against the JAX package's
``DistributedMapReduce`` on ``make_mesh(2)`` (its virtual CPU mesh), on
the same seeded inputs (tests/torch_mesh_rig.py).  One world per module
runs every scenario: each sort mode, hot-key skew, tight bins drained in
extra rounds, drop mode, truncation, explicit bins, ``count``, a sync
every round, ``run_stream == run``, and a crash and resume.

What must match: host pairs byte for byte; ``distinct``,
``drain_rounds``, ``emit_overflow``, ``shuffle_overflow``,
``truncated``, ``fused_kernel`` and ``fused_demoted``; and each rank's
shard of the table bit for bit.  JAX's CPU mesh runs neither Pallas
kernel (bitonic sorts by its stock ``lax.sort``; fused demotes to hasht)
and the port's CPU ranks take the plain versions and demote the same
way.  The tables are bit-identical in every mode here: the hasht
family's table is a function of the keys and totals alone, and these
corpora have no two keys sharing a folded sort key.  Only drop mode
loses rows, and which ones depends on each package's order within a
bin, so there only the loss count is compared."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import numpy as np
import pytest

import torch_mesh_rig as rig
from helpers import py_wordcount

from locust_tpu import parallel as jparallel
from locust_tpu.parallel import make_mesh


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("flat_world"))
    procs = rig.start_world("torch", 2, out, "flat")
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


def _oracle(kind, cfg_kw):
    emits = {**rig.CFG, **cfg_kw}["emits_per_line"]
    return {k.hex(): v for k, v in py_wordcount(rig.lines_of(kind), emits).items()}


@pytest.mark.parametrize("name", sorted(rig.FLAT))
def test_world_of_two_equals_jax(world, name):
    want, want_table = rig.run_flat(rig.jax_pkg(), jparallel, make_mesh(2), name)
    got = _port(world)[name]
    with np.load(f"{world['out']}/{name}.npz") as z:
        got_table = {k: z[k] for k in z.files}
    for k in rig.STATS:
        assert got[k] == want[k], (name, k, got[k], want[k])
    kind, cfg_kw, eng_kw, _ = rig.FLAT[name]
    if eng_kw.get("on_overflow") == "drop":
        assert got["shuffle_overflow"] > 0 and got["drain_rounds"] == 0
        oracle = _oracle(kind, cfg_kw)
        assert all(oracle[k] >= v for k, v in got["pairs"])
        return
    assert got["pairs"] == want["pairs"]
    if not got["truncated"]:
        assert dict(map(tuple, got["pairs"])) == _oracle(kind, cfg_kw)
    for k in ("key_lanes", "values", "valid"):
        assert got_table[k].dtype == want_table[k].dtype
        assert np.array_equal(got_table[k], want_table[k]), (name, k)


def test_scenarios_exercise_what_they_name(world):
    got = _port(world)
    assert got["skew"]["drain_rounds"] > 0 and got["skew_hasht"]["drain_rounds"] > 0
    assert got["tight"]["drain_rounds"] > 0 and got["trunc"]["truncated"]
    assert got["hot"]["shuffle_overflow"] == 0
    assert got["mode_fused"]["fused_demoted"] and got["mode_fused"]["fused_kernel"] is None
    assert got["count"]["pairs"] == [[b"same".hex(), 3 * 256]]
    # The shuffle crossed processes: one all-to-all per shuffle round.
    assert got["comm"]["all_to_all"]["calls"] > 0


def test_run_stream_equals_run(world):
    assert _port(world)["stream"] == _port(world)["mode_hash"]["pairs"]


def test_crash_and_resume_skips_the_folded_rounds(world):
    got = _port(world)["crash"]
    assert dict(map(tuple, got["pairs"])) == _oracle("resume", {})
    # The crash fires before round 2 with a snapshot every round: the
    # resume folds exactly the rounds after it, and a third run none.
    assert got["resumed_rounds"] == got["nrounds"] - 2
    assert got["third_run_steps"] == 0 and got["third_run_same"]
    import os

    for pid in (0, 1):
        assert os.path.exists(f"{world['out']}/ckpt_flat/state.p{pid}.npz")
