"""PyTorch port, plan jobs through the serve daemon against the JAX
daemon's (tests/test_serve.py:1691-1822): a plan submit answers the
pipeline's rendered bytes as one (bytes, 0) pair, the result cache keys
off the plan fingerprint, a repeat over new bytes is a warm executable
hit, bad plans and deterministic plan errors fail structured, the
sub-plan cache counts as the JAX one does, and a journaled plan job
replays after a kill -9."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import base64

import pytest
from torch_serve_rig import (
    CFG_OVR,
    CORPUS_A,
    abandon,
    error_view,
    pair,
    result_view,
    start,
    stats_view,
)

from locust_tpu import plan as jplan
from locust_tpu.config import EngineConfig as JCfg
from locust_tpu.plan.compile import compile_plan as jcompile
from locust_tpu.serve import ServeError as JError
from locust_tpu_torch import plan as tplan
from locust_tpu_torch.config import EngineConfig as TCfg
from locust_tpu_torch.serve import ServeError as TError
from locust_tpu_torch.serve.cache import ExecutableCache
from locust_tpu_torch.serve.jobs import PLAN_WORKLOAD, Job, JobSpec
from locust_tpu_torch.utils import faultplan

RIG = dict(max_queue=8, max_batch=4, dispatch_poll_s=0.02)
TFIDF = tplan.tfidf_plan(2).to_doc()


def oracle(corpus: bytes, doc=TFIDF) -> bytes:
    return jcompile(jplan.from_doc(doc), JCfg(**CFG_OVR)).run_corpus(corpus).output


def both(fn, rigs):
    return [fn(d, c) for d, c in rigs]


def outcome(fn, client):
    try:
        return fn(client)
    except (JError, TError) as e:
        return error_view(e), str(e)


@pytest.fixture
def rigs():
    with pair(**RIG) as r:
        yield r


def test_plan_submit_roundtrip_and_result_cache_by_plan_fingerprint(rigs):
    def go(d, c):
        a1 = c.submit(corpus=CORPUS_A, config=CFG_OVR, plan=TFIDF)
        r1 = result_view(c.wait(a1["job_id"], timeout=120.0))
        st = c.status(a1["job_id"])
        a2 = c.submit(corpus=CORPUS_A, config=CFG_OVR, plan=TFIDF)
        r2 = result_view(c.result(a2["job_id"]))
        a3 = c.submit(corpus=CORPUS_A, config=CFG_OVR, plan=tplan.tfidf_plan(3).to_doc())
        r3 = result_view(c.wait(a3["job_id"], timeout=120.0))
        return (a1["cached"], a2["cached"], a3["cached"], r1, r2, r3,
                (st["workload"], st["placed_on"]), stats_view(c.stats()))

    j, t = both(go, rigs)
    assert t == j
    assert t[:3] == (False, True, False) and t[6] == ("plan", "local")
    assert t[3]["plan"] is True and t[3]["pairs"] == [(oracle(CORPUS_A), 0)]
    assert t[5]["pairs"] == [(oracle(CORPUS_A, jplan.tfidf_plan(3).to_doc()), 0)]


def test_plan_repeat_over_new_bytes_is_a_warm_hit(rigs):
    corpus2 = CORPUS_A.replace(b"alpha", b"omega")

    def go(d, c):
        for x in (CORPUS_A, corpus2):
            ack = c.submit(corpus=x, config=CFG_OVR, plan=TFIDF, no_cache=True)
            res = result_view(c.wait(ack["job_id"], timeout=120.0))
        return res, c.stats()["exec_cache"], c.stats()["subplan_cache"]

    j, t = both(go, rigs)
    assert t == j and t[0]["cache"] == "warm" and t[1]["compiles"] == 1
    assert t[0]["pairs"] == [(oracle(corpus2), 0)]


@pytest.mark.parametrize("name", ["wordcount", "index"])
def test_other_plans_answer_like_jax(rigs, name):
    doc = getattr(tplan, f"{name}_plan")().to_doc()

    def go(d, c):
        ack = c.submit(corpus=CORPUS_A, config=CFG_OVR, plan=doc)
        return result_view(c.wait(ack["job_id"], timeout=120.0))

    j, t = both(go, rigs)
    assert t == j and t["pairs"] == [(oracle(CORPUS_A, doc), 0)]


def test_bad_plans_are_structured(rigs):
    raw = {"cmd": "submit", "workload": "wordcount", "plan": TFIDF,
           "corpus_b64": base64.b64encode(CORPUS_A).decode()}

    def go(d, c):
        bad = outcome(lambda c: c.submit(corpus=CORPUS_A, plan={
            "plan_version": 1, "nodes": [{"id": "a", "kind": "window", "op": "text"}]}), c)
        with pytest.raises(ValueError, match="not both"):
            c.submit(corpus=CORPUS_A, workload="other", plan=TFIDF)
        resp = c.rpc(raw)
        return bad, (resp["status"], resp["code"], resp["error"])

    j, t = both(go, rigs)
    assert t == j and t[0][0][0] == "bad_spec" and "unknown kind" in t[0][1]


def test_deterministic_plan_errors_fail_structured_not_poison(rigs):
    doc = tplan.pagerank_plan(3).to_doc()

    def go(d, c):
        out = []
        for corpus in (b"alpha beta gamma\nnot an edge list\n", b"0 2000000000\n"):
            ack = c.submit(corpus=corpus, plan=doc)
            out.append(outcome(lambda c: c.wait(ack["job_id"], timeout=60.0), c))
            st = c.status(ack["job_id"])
            out.append((st["state"], st["attempts"]))
        return out

    j, t = both(go, rigs)
    assert t == j
    assert t[0][0][0] == "bad_spec" and "edge list" in t[0][1] and "cap" in t[2][1]
    assert t[1] == t[3] == ("failed", 0)


def test_plan_jobs_dispatch_solo_and_key_by_the_plan():
    d, _ = start("torch", **RIG)
    try:
        spec = JobSpec(tenant="t", workload=PLAN_WORKLOAD, cfg=TCfg(**CFG_OVR),
                       plan=tplan.tfidf_plan(2).canonical_json())
        jobs = [Job(job_id=f"p{i}", spec=spec, corpus_digest="d", n_lines=999,
                    n_blocks=256, bucket=256) for i in range(2)]
        assert d._batch_key(jobs[0]) != d._batch_key(jobs[1])
        assert spec.plan_fingerprint() in ExecutableCache.engine_key(spec)
    finally:
        d.close()


def test_plan_job_replays_from_journal(tmp_path):
    jdir = str(tmp_path / "journal")
    d, c = start("torch", journal_dir=jdir, **RIG)
    p = faultplan.FaultPlan([{"site": "serve.dispatch", "action": "delay",
                              "delay_s": 30.0, "times": 1}], seed=3)
    with faultplan.active_plan(p):
        ack = c.submit(corpus=CORPUS_A, config=CFG_OVR, plan=TFIDF, no_cache=True)
        abandon(d)
    d2, c2 = start("torch", journal_dir=jdir, **RIG)
    try:
        res = c2.wait(ack["job_id"], timeout=120.0)
        assert res["plan"] is True and res["pairs"] == [(oracle(CORPUS_A), 0)]
    finally:
        d2.close()
