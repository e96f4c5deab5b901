"""PyTorch port and JAX package mixed in one serve deployment: a JAX
daemon over port ``--serve`` workers and a port daemon over JAX ones
(``serve_batch`` jobs, a sharded job and ``plan_stage`` waves), a JAX
primary shipping its journal to a port standby and the reverse, and a
journal holding distributed-plan stage records replayed by the other
package.  What crosses the packages is state and wire: journals, epoch
files, corpus spills, partition files.  Every answer equals the one the
daemon's own package gives over its own workers, on the CPU."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import threading
import time

import pytest
from torch_serve_rig import (
    CFG_OVR,
    CORPUS_A,
    CORPUS_B,
    SECRET,
    abandon,
    ha_pair,
    oracle,
    pool,
    result_view,
    roster,
    start,
    start_workers,
    stop_workers,
    wait_replicated,
)

from locust_tpu.serve import ServeClient as JClient
from locust_tpu_torch import plan as tplan
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.plan.compile import compile_plan
from locust_tpu_torch.serve import ServeClient as TClient

CLIENTS = {"jax": JClient, "torch": TClient}
OTHER = {"jax": "torch", "torch": "jax"}
CORPUS = CORPUS_A + CORPUS_B
EDGES = b"0 1\n1 2\n2 0\n0 2\n3 1\n2 3\n" * 3
BIG = b"".join(f"t{i % 29} common x{i % 7}\n".encode() for i in range(80))
PLANS = {"tfidf": (tplan.tfidf_plan(2).to_doc(), CORPUS),
         "index": (tplan.index_plan(2).to_doc(), CORPUS),
         "pagerank": (tplan.pagerank_plan(3).to_doc(), EDGES)}


def drive(client) -> dict:
    """Two small jobs, one that shards over both workers, and the
    distributed plans: each answer and where it ran."""
    out = {}
    for name, corpus in (("a", CORPUS_A), ("b", CORPUS_B), ("big", BIG)):
        ack = client.submit(corpus=corpus, config=CFG_OVR, no_cache=True)
        res = client.wait(ack["job_id"], timeout=120.0)
        out[name] = (result_view(res), client.status(ack["job_id"])["placed_on"].split(":")[0])
    for name, (doc, corpus) in PLANS.items():
        ack = client.submit(corpus=corpus, config=CFG_OVR, plan=doc, no_cache=True)
        res = client.wait(ack["job_id"], timeout=120.0)
        out[name] = (result_view(res), client.status(ack["job_id"])["placed_on"].split(":")[0])
    return out


@pytest.fixture(scope="module")
def own_answers():
    """Each package's daemon over its own workers: the reference."""
    out = {}
    for pkg in ("jax", "torch"):
        with pool(pkg, shard_min_blocks=3, shard_max=2) as (_, _, c):
            out[pkg] = drive(c)
    assert out["torch"] == out["jax"]
    return out["torch"]


@pytest.mark.parametrize("daemon_pkg", ["jax", "torch"])
def test_daemon_over_the_other_packages_workers(own_answers, daemon_pkg):
    """``serve_batch`` and ``plan_stage`` across the packages: the
    answers, placements included, equal the daemon's over its own."""
    with pool(daemon_pkg, workers_pkg=OTHER[daemon_pkg], shard_min_blocks=3,
              shard_max=2) as (_, _, c):
        got = drive(c)
        assert c.stats()["pool"]["plan"]["plan_solo_fallbacks"] == 0
    assert got == own_answers
    assert {k: v[1] for k, v in got.items()} == {
        "a": "127.0.0.1", "b": "127.0.0.1", "big": "shard", "tfidf": "plan", "index": "plan",
        "pagerank": "plan"}
    assert dict(got["big"][0]["pairs"]) == oracle(BIG)
    doc, corpus = PLANS["pagerank"]
    want = compile_plan(tplan.from_doc(doc), EngineConfig(**CFG_OVR), device="cpu") \
        .run_corpus(corpus).output
    assert got["pagerank"][0]["pairs"][0][0] == want


@pytest.mark.parametrize("primary_pkg", ["jax", "torch"])
def test_primary_ships_to_the_other_packages_standby(tmp_path, primary_pkg):
    """The primary's journal ships to a standby of the other package,
    which promotes and answers each acked job under its original id; a
    ship of the old epoch is then refused ``stale_epoch``."""
    standby_pkg = OTHER[primary_pkg]
    with ha_pair(tmp_path, primary_pkg, standby_pkg) as (primary, standby):
        primary.scheduler.pause()
        pc = CLIENTS[primary_pkg](primary.addr, SECRET, timeout=30.0)
        ids = [pc.submit(corpus=c, config=CFG_OVR, no_cache=True)["job_id"]
               for c in (CORPUS_A, CORPUS_B)]
        wait_replicated(standby, 2)
        abandon(primary)
        sc = CLIENTS[standby_pkg](standby.addr, SECRET, timeout=30.0)
        assert sc.promote()["epoch"] == 2
        assert [dict(sc.wait(j, timeout=60.0)["pairs"]) for j in ids] == \
            [oracle(CORPUS_A), oracle(CORPUS_B)]
        fenced = sc._rpc_one(standby.addr, {"cmd": "ship", "_epoch": 1, "from": "127.0.0.1:9"})
        assert fenced.get("code") == "stale_epoch" and fenced.get("epoch") == 2


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stage_records_replay_in_the_other_package(tmp_path, writer):
    """A daemon of one package dies after a distributed plan's map wave
    journaled its stage records; a daemon of the other package restarts
    on the journal (over the same workers), reuses the surviving
    partitions and answers the solo engine's bytes under the original
    id.  The dead daemon is in this process: until the other has
    answered, its reduce wave is held, as a killed process would be.  (A
    timed stall let it wake, fail on its closed journal and unlink the
    map wave's partitions before a reader slowed by load checked them.)"""
    reader = OTHER[writer]
    doc = tplan.tfidf_plan(2).to_doc()
    mk = dict(journal_dir=str(tmp_path / "journal"), shard_min_blocks=1, max_queue=16,
              max_batch=4, dispatch_poll_s=0.02, retry_base_s=0.02)
    killed = threading.Event()
    ws = start_workers("torch", 1) + start_workers("jax", 1)
    try:
        d, c = start(writer, workers=roster(ws), **mk)
        stage_rpc = d._run_plan_stage_rpc

        def held_past_the_map_wave(worker, req, phase):
            if phase != "map":
                killed.wait(timeout=300.0)
                raise RuntimeError("a killed daemon takes no further step")
            return stage_rpc(worker, req, phase)

        d._run_plan_stage_rpc = held_past_the_map_wave
        try:
            ack = c.submit(corpus=CORPUS, config=CFG_OVR, plan=doc, no_cache=True)
            deadline = time.monotonic() + 30.0
            while True:
                with open(d.journal.path, "rb") as f:
                    if f.read().count(b'"rec":"stage"') >= 2:
                        break
                assert time.monotonic() < deadline, "no stage records journaled"
                time.sleep(0.02)
            abandon(d)
        finally:
            d.journal.close()
        d2, c2 = start(reader, workers=roster(ws), **mk)
        try:
            res = c2.wait(ack["job_id"], timeout=120.0)
            want = compile_plan(tplan.from_doc(doc), EngineConfig(**CFG_OVR),
                                device="cpu").run_corpus(CORPUS).output
            assert res["pairs"][0][0] == want
            assert c2.status(ack["job_id"])["placed_on"].startswith("plan:")
            assert c2.stats()["pool"]["plan"]["partitions_reused"] >= 2
        finally:
            d2.close()
    finally:
        killed.set()
        stop_workers(ws)
