"""PyTorch port, distributed plan execution against the JAX package's:
``plan_shape`` on the same plans, the shuffle keying and the partition
files (byte for byte), the covered plans (WordCount, tf-idf, index, join
trees, PageRank) run as stage waves over two in-thread port workers, the
WAL resume from stage records, the demotions to the solo engine, and the
``plan.stage`` and ``plan.partition`` fault sites.  Every answer equals
the port's solo engine and the JAX pool's under the same calls, on the
CPU, PageRank bit for bit."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
from torch_serve_rig import (
    CFG_OVR,
    CORPUS_A,
    CORPUS_B,
    abandon,
    pool,
    roster,
    start,
    start_workers,
    stop_workers,
)

from locust_tpu import plan as jplan
from locust_tpu.plan import distribute as jdist
from locust_tpu.utils import faultplan as jfaults
from locust_tpu_torch import plan as tplan
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.plan import distribute as tdist
from locust_tpu_torch.plan.compile import compile_plan
from locust_tpu_torch.serve.journal import JobJournal
from locust_tpu_torch.utils import faultplan as tfaults

FAULTS = {"jax": jfaults, "torch": tfaults}
CORPUS = CORPUS_A + CORPUS_B
EDGES = b"0 1\n1 2\n2 0\n0 2\n3 1\n2 3\n" * 3
CFG = EngineConfig(**CFG_OVR)


def join_doc(combine="sum", deep=False) -> dict:
    """A join tree of WordCount fold leaves as a plan document; ``deep``
    chains a second join (of combine "mul") on top."""
    def spine(i):
        return [{"id": f"c{i}", "kind": "source", "op": "text", "inputs": [], "params": {}},
                {"id": f"m{i}", "kind": "map", "op": "tokenize_count", "inputs": [f"c{i}"],
                 "params": {}},
                {"id": f"s{i}", "kind": "shuffle", "op": "by_key", "inputs": [f"m{i}"],
                 "params": {}},
                {"id": f"r{i}", "kind": "reduce", "op": "sum", "inputs": [f"s{i}"],
                 "params": {}}]

    nodes = spine(1) + spine(2) + [{"id": "j1", "kind": "join", "op": "inner",
                                    "inputs": ["r1", "r2"], "params": {"combine": combine}}]
    top = "j1"
    if deep:
        nodes += spine(3) + [{"id": "j2", "kind": "join", "op": "inner",
                              "inputs": ["j1", "r3"], "params": {"combine": "mul"}}]
        top = "j2"
    nodes.append({"id": "out", "kind": "sink", "op": "table", "inputs": [top], "params": {}})
    return {"plan_version": tplan.PLAN_VERSION, "nodes": nodes}


def docs() -> dict:
    """Every plan of the module as a document both packages read."""
    return {
        "wordcount": tplan.wordcount_plan().to_doc(),
        "tfidf": tplan.tfidf_plan(2).to_doc(),
        "index": tplan.index_plan(2).to_doc(),
        "join_sum": join_doc("sum"),
        "join_min": join_doc("min"),
        "join_deep": join_doc(deep=True),
        "pagerank": tplan.pagerank_plan(4).to_doc(),
        "pagerank_d09": tplan.pagerank_plan(3, damping=0.9).to_doc(),
    }


def solo(doc: dict, corpus: bytes, cfg=CFG) -> bytes:
    return compile_plan(tplan.from_doc(doc), cfg, device="cpu").run_corpus(corpus).output


def corpus_of(name: str) -> bytes:
    return EDGES if name.startswith("pagerank") else CORPUS


@pytest.fixture(scope="module")
def pools():
    """A JAX and a port daemon, each over 2 serve workers of its package;
    every plan of 1 block or more distributes."""
    with pool("jax", shard_min_blocks=1) as jp, pool("torch", shard_min_blocks=1) as tp:
        yield {"jax": jp, "torch": tp}


def submit_plan(client, doc: dict, corpus: bytes, config=None, **kw):
    ack = client.submit(corpus=corpus, config=config or CFG_OVR, plan=doc, no_cache=True,
                        **kw)
    res = client.wait(ack["job_id"], timeout=120.0)
    return res, client.status(ack["job_id"])


def shape_view(shape) -> tuple:
    return type(shape).__name__, dataclasses.asdict(shape)


def test_plan_shape_equals_jax():
    named = {"plan_version": tplan.PLAN_VERSION, "nodes": [
        n if n["id"] != "c2" else dict(n, params={"input": "aux"})
        for n in join_doc()["nodes"]]}
    extra = {"plan_version": tplan.PLAN_VERSION, "nodes": [
        *tplan.wordcount_plan().to_doc()["nodes"],
        {"id": "tee", "kind": "map", "op": "tokenize_count",
         "inputs": [tplan.wordcount_plan().to_doc()["nodes"][0]["id"]], "params": {}}]}
    cases = dict(docs(), named=named)
    for name, doc in cases.items():
        j, jr = jdist.plan_shape(jplan.from_doc(doc))
        t, tr = tdist.plan_shape(tplan.from_doc(doc))
        assert tr == jr, name
        assert (t is None) == (j is None), name
        if t is not None:
            assert shape_view(t) == shape_view(j), name
    assert tdist.plan_shape(tplan.from_doc(named)) == (None, "source_named_input")
    with pytest.raises(Exception):
        tplan.from_doc(extra)  # a dangling map: invalid in both packages
    with pytest.raises(Exception):
        jplan.from_doc(extra)
    deep, _ = tdist.plan_shape(tplan.from_doc(join_doc(deep=True)))
    assert deep.depth == 2 and len(deep.leaves) == 3
    assert tdist.SOLO_ONLY == jdist.SOLO_ONLY


def test_shuffle_keys_and_partition_files_equal_jax(tmp_path):
    """The partitioner, the key codec, the LKVB partition files (byte for
    byte, empty partitions included), their refs, and the read gate."""
    for fold in ("wordcount", "tf", "index"):
        assert tdist.partition_key_width(CFG, fold) == jdist.partition_key_width(CFG, fold)
    keys = [b"alpha", b"", b"\xff" * 16] + [tdist.encode_key("tf", (b"w%d" % i, i))
                                           for i in range(40)]
    for k in keys:
        assert [tdist.partition_of(k, n) for n in (1, 2, 3, 7)] == \
            [jdist.partition_of(k, n) for n in (1, 2, 3, 7)]
    assert tdist.encode_key("tf", (b"alpha", 7)) == jdist.encode_key("tf", (b"alpha", 7))
    assert tdist.decode_key("tf", b"alpha\x0012") == (b"alpha", 12)
    pairs = [(tdist.encode_key("tf", (w, d)), c)
             for w, d, c in ((b"alpha", 0, 3), (b"beta", 1, 2), (b"gamma", 0, 1),
                             (b"alpha", 1, 5), (b"delta", 9, 2**31 - 1))]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jrefs = jdist.publish_split(str(tmp_path / "j"), "fp0", 0, 1, pairs, 3)
    trefs = tdist.publish_split(str(tmp_path / "t"), "fp0", 0, 1, pairs, 3)
    for jr, tr in zip(jrefs, trefs):
        assert os.path.basename(tr["path"]) == os.path.basename(jr["path"])
        assert {k: v for k, v in tr.items() if k != "path"} == \
            {k: v for k, v in jr.items() if k != "path"}
        with open(jr["path"], "rb") as f, open(tr["path"], "rb") as g:
            assert f.read() == g.read()
    width = tdist.partition_key_width(CFG, "tf")
    got = {}
    for ref in jrefs:  # the port reads the JAX package's files
        tdist.merge_pairs(got, tdist.read_partition(ref["path"], ref["sha256"], width))
    assert got == dict(pairs)
    victim = next(r for r in trefs if r["pairs"])
    with open(victim["path"], "r+b") as f:
        f.write(b"\xff\xff")
    with pytest.raises(ValueError, match="sha mismatch"):
        tdist.read_partition(victim["path"], victim["sha256"], width)
    os.unlink(victim["path"])
    with pytest.raises(ValueError, match="unreadable"):
        tdist.read_partition(victim["path"], victim["sha256"], width)
    # Rank shards: the float32 bits round-trip, and the files match.
    ranks = np.random.default_rng(3).random(11).astype(np.float32)
    assert tdist.encode_rank_pairs(5, ranks) == jdist.encode_rank_pairs(5, ranks)
    assert tdist.decode_rank_values(tdist.encode_rank_pairs(5, ranks)).tobytes() == \
        ranks.tobytes()
    assert tdist.shard_ranges(11, 3) == jdist.shard_ranges(11, 3)
    assert tdist.finalize_ranks([ranks[:5], ranks[5:]]) == \
        jdist.finalize_ranks([ranks[:5], ranks[5:]])
    # Join trees on the wire and per bin.
    tree = tdist.plan_shape(tplan.from_doc(join_doc(deep=True)))[0].tree
    jtree = jdist.plan_shape(jplan.from_doc(join_doc(deep=True)))[0].tree
    table = {b"a": 3, b"b": 2, b"c": 5}
    assert tdist.tree_doc(tree) == jdist.tree_doc(jtree)
    assert tdist.eval_tree_doc(tdist.tree_doc(tree), table) == \
        jdist.eval_tree_doc(jdist.tree_doc(jtree), table)
    bins = [[(b"b", 4)], [(b"a", 9), (b"c", 2**40)]]
    assert tdist.finalize_join(bins) == jdist.finalize_join(bins)


@pytest.mark.parametrize("name", list(docs()))
def test_distributed_plans_equal_solo_and_jax(pools, name):
    """Each covered plan runs distributed (``placed_on`` names both
    workers) and answers what the port's solo engine renders, and what
    the JAX pool answers, byte for byte."""
    doc, corpus = docs()[name], corpus_of(name)
    answers = {}
    for pkg, (d, _, c) in pools.items():
        res, st = submit_plan(c, doc, corpus)
        assert res["plan"] is True and res["cache"] == "distributed", (pkg, res["cache"])
        assert st["placed_on"] == "plan:" + ",".join(w.name for w in d.pool.workers), pkg
        answers[pkg] = (res["pairs"], res["distinct"], res["truncated"],
                        res["overflow_tokens"], st["shards"])
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][0][0][0] == solo(doc, corpus)


def test_repeat_distributed_plan_is_warm_on_the_workers(pools):
    """A repeated join lands every map split on the workers' warm
    fold-node engines: their ``compiles`` stay flat, ``map_warm_hits``
    counts the splits, nothing is demoted, as in JAX."""
    def go(pkg):
        d, ws, c = pools[pkg]
        submit_plan(c, join_doc("sum"), CORPUS)
        before = c.stats()["pool"]["plan"]
        pre = [w._serve_cache.stats()["compiles"] for w in ws]
        res, _ = submit_plan(c, join_doc("sum"), CORPUS)
        after = c.stats()["pool"]["plan"]
        return (res["pairs"], [w._serve_cache.stats()["compiles"] for w in ws] == pre,
                after["map_warm_hits"] - before["map_warm_hits"],
                after["plan_solo_fallbacks"])

    j, t = go("jax"), go("torch")
    assert t == j
    assert t[1:] == (True, 2, 0)


def test_demotions_to_the_solo_engine_counted_like_jax():
    """Under the shard floor, one worker, and a join past the solo table:
    each lands on the daemon's solo engine byte-identically, and the
    daemon counts the same demotions as JAX."""
    tiny = dict(CFG_OVR, table_size=8)
    cases = [({"shard_min_blocks": 8}, 2, jplan.tfidf_plan(2).to_doc(), CFG_OVR),
             ({"shard_min_blocks": 1}, 1, jplan.tfidf_plan(2).to_doc(), CFG_OVR),
             ({"shard_min_blocks": 1}, 2, join_doc("sum"), tiny)]
    for cfg_kw, n, doc, config in cases:
        out = {}
        for pkg in ("jax", "torch"):
            with pool(pkg, n_workers=n, **cfg_kw) as (_, _, c):
                res, st = submit_plan(c, doc, CORPUS, config)
                out[pkg] = (res["pairs"], st["placed_on"],
                            c.stats()["pool"]["plan"]["plan_solo_fallbacks"])
        assert out["torch"] == out["jax"], cfg_kw
        assert out["torch"][0][0][0] == solo(doc, CORPUS, EngineConfig(**config))
        assert out["torch"][1] == "local"


def test_journal_stage_records_replay_with_their_admit(tmp_path):
    from locust_tpu_torch.serve.jobs import Job, JobSpec

    j = JobJournal(str(tmp_path))
    job = Job(job_id="dp1", spec=JobSpec(tenant="t", workload="wordcount", cfg=CFG),
              corpus_digest="", n_lines=1, n_blocks=1, bucket=1)
    j.append_admit(job, b"corpus bytes\n")
    j.append_stage("dp1", {"split": 0, "attempt": 0, "parts": []})
    j.append_stage("dp1", {"split": 1, "attempt": 0, "parts": []})
    j.append_stage("ghost", {"split": 9})  # no admit: dropped
    j.close()
    by_id = {e.admit["job_id"]: e for e in JobJournal(str(tmp_path)).replay()}
    assert [s["split"] for s in by_id["dp1"].stages] == [0, 1]
    assert "ghost" not in by_id


@pytest.mark.parametrize("kind", ["map", "iterate"])
def test_wal_resume_from_stage_records(tmp_path, kind):
    """The daemon dies after the map wave (or PageRank's first epoch)
    journaled its stage records; a restart on the journal reuses the
    surviving partitions (``partitions_reused``) and answers what the
    solo engine renders.  The dead daemon is in this process: its next
    stage RPCs are held until the restart has answered, as a killed
    process would take no further step (a timed stall let it wake and
    unlink the partitions under a restart slowed by load)."""
    if kind == "map":
        doc, corpus = tplan.tfidf_plan(2).to_doc(), CORPUS
        stall = {"phase": "reduce"}
    else:
        doc, corpus = tplan.pagerank_plan(3).to_doc(), EDGES
        stall = {"phase": "iterate", "split": 2}
    mk = dict(journal_dir=str(tmp_path / "journal"), shard_min_blocks=1, max_queue=16,
              max_batch=4, dispatch_poll_s=0.02, retry_base_s=0.02)
    killed = threading.Event()
    ws = start_workers("torch", 2)
    try:
        d, c = start("torch", workers=roster(ws), **mk)
        stage_rpc = d._run_plan_stage_rpc

        def held_at_the_stall(worker, req, phase):
            if all((phase if k == "phase" else req.get(k)) == v for k, v in stall.items()):
                killed.wait(timeout=300.0)
                raise RuntimeError("a killed daemon takes no further step")
            return stage_rpc(worker, req, phase)

        d._run_plan_stage_rpc = held_at_the_stall
        try:
            ack = c.submit(corpus=corpus, config=CFG_OVR, plan=doc, no_cache=True)
            deadline = time.monotonic() + 30.0
            need = 2 if kind == "map" else 1
            while True:
                with open(d.journal.path, "rb") as f:
                    if f.read().count(b'"rec":"stage"') >= need:
                        break
                assert time.monotonic() < deadline, "no stage record journaled"
                time.sleep(0.02)
            abandon(d)
        finally:
            d.journal.close()
        d2, c2 = start("torch", workers=roster(ws), **mk)
        try:
            res = c2.wait(ack["job_id"], timeout=120.0)
            assert res["pairs"][0][0] == solo(doc, corpus)
            assert c2.status(ack["job_id"])["placed_on"].startswith("plan:")
            assert c2.stats()["pool"]["plan"]["partitions_reused"] >= (2 if kind == "map" else 1)
        finally:
            d2.close()
    finally:
        killed.set()
        stop_workers(ws)


@pytest.mark.parametrize("rule", [
    {"site": "plan.stage", "action": "error", "match": {"phase": "map"}, "times": 1},
    {"site": "plan.stage", "action": "crash", "match": {"phase": "reduce"}, "times": 1},
    {"site": "plan.partition", "action": "drop", "times": 1},
    {"site": "plan.partition", "action": "corrupt", "times": 1},
], ids=["stage-error", "stage-crash", "partition-drop", "partition-corrupt"])
def test_plan_fault_sites_recompute_like_jax(pools, rule):
    """``plan.stage`` and ``plan.partition``: the stage or the lost split
    recomputes on a survivor, the answer stays the solo engine's, and
    both packages fire the rule and count the same recomputes."""
    doc = tplan.tfidf_plan(2).to_doc()

    def go(pkg):
        _, _, c = pools[pkg]
        fp = FAULTS[pkg]
        before = c.stats()["pool"]["plan"]["recomputes"]
        with fp.active_plan(fp.FaultPlan([rule], seed=5)) as plan:
            res, st = submit_plan(c, doc, CORPUS)
            fired = [r.fired for r in plan.rules]
        return (res["pairs"], st["state"], st["placed_on"].startswith("plan:"), fired,
                c.stats()["pool"]["plan"]["recomputes"] - before)

    j, t = go("jax"), go("torch")
    assert t == j
    assert t[0][0][0] == solo(doc, CORPUS)
    assert t[1:4] == ("done", True, [1]) and t[4] >= 1


def test_zombie_stage_publish_is_fenced():
    """Workers that served a newer primary answer a stale coordinator's
    stage RPC ``stale_epoch``; the daemon demotes itself to standby, as
    the JAX daemon does."""
    from locust_tpu_torch.serve import ServeError

    with pool("torch", shard_min_blocks=1) as (d, ws, c):
        for w in ws:
            w._epoch_guard.observe(d.epoch + 7)
        ack = c.submit(corpus=CORPUS, config=CFG_OVR, plan=tplan.tfidf_plan(2).to_doc(),
                       no_cache=True, max_attempts=1)
        with pytest.raises(ServeError):
            c.wait(ack["job_id"], timeout=60.0)
        assert d.role == "standby" and d._seen_epoch >= d.epoch + 7
