"""PyTorch port, the serve tier's units against their JAX counterparts
under the same calls: spec validation codes and fingerprints, the fair
scheduler's order and stats, the bucket ladder and line counter, the
executable / result / sub-plan caches' counters, ``merge_shard_results``,
and ``stage_batch`` + ``run_batch``'s demux per sort mode."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import base64
import dataclasses
import random

import pytest
from torch_serve_rig import CFG_OVR, CORPUS_A, CORPUS_B, KCFG_OVR

from locust_tpu import plan as jplan
from locust_tpu.config import EngineConfig as JCfg
from locust_tpu.engine import MapReduceEngine as JEngine
from locust_tpu.serve import batch as jbatch
from locust_tpu.serve import cache as jcache
from locust_tpu.serve import jobs as jjobs
from locust_tpu.serve import scheduler as jsched
from locust_tpu_torch import plan as tplan
from locust_tpu_torch.config import EngineConfig as TCfg
from locust_tpu_torch.engine import MapReduceEngine as TEngine
from locust_tpu_torch.serve import batch as tbatch
from locust_tpu_torch.serve import cache as tcache
from locust_tpu_torch.serve import jobs as tjobs
from locust_tpu_torch.serve import scheduler as tsched

PKGS = {
    "jax": (jjobs, jsched, jcache, jbatch, JCfg),
    "torch": (tjobs, tsched, tcache, tbatch, TCfg),
}
GOOD = {"corpus_b64": base64.b64encode(b"a b c\n").decode()}


def both(fn):
    """``fn(jobs, sched, cache, batch, Cfg)`` for each package."""
    return [fn(*PKGS[p]) for p in ("jax", "torch")]


def mk_job(jobs, cfg_cls, tenant="t", weight=1.0, bucket=1, job_id="j", ovr=CFG_OVR):
    spec = jobs.JobSpec(tenant=tenant, workload="wordcount", cfg=cfg_cls(**ovr),
                        weight=weight)
    return jobs.Job(job_id=job_id, spec=spec, corpus_digest=job_id, n_lines=1,
                    n_blocks=bucket, bucket=bucket)


def const_key(job):
    return ("k", job.bucket)


# ------------------------------------------------------------ job model


def test_registries_equal_jax():
    assert tjobs.ERROR_CODES == jjobs.ERROR_CODES
    assert tjobs.JOB_STATES == jjobs.JOB_STATES
    assert tjobs.SPEC_CONFIG_KEYS == jjobs.SPEC_CONFIG_KEYS
    assert "use_pallas" not in tjobs.SPEC_CONFIG_KEYS
    assert set(tjobs.WORKLOADS) == set(jjobs.WORKLOADS)
    assert tjobs.PLAN_WORKLOAD == jjobs.PLAN_WORKLOAD
    assert tjobs.WORKLOADS["wordcount"][0] == "locust_tpu_torch.ops.map_stage:wordcount_map"


@pytest.mark.parametrize("req", [
    {"workload": "nope", **GOOD}, {}, {"corpus_b64": "!!!"}, {"path": "/nonexistent/x"},
    {"config": {"bogus_knob": 1}, **GOOD}, {"config": {"sort_mode": "nope"}, **GOOD},
    {"config": {"use_pallas": True}, **GOOD}, {"config": [1], **GOOD},
    {"weight": -1, **GOOD}, {"weight": "x", **GOOD}, {"deadline_s": 0, **GOOD},
    {"deadline_s": 7200, **GOOD}, {"max_attempts": 0, **GOOD}, {"max_attempts": 17, **GOOD},
    {"plan": "{not json", **GOOD}, {"plan": {"nodes": []}, **GOOD},
    {"plan": {"nodes": []}, "workload": "wordcount", **GOOD},
], ids=lambda r: ",".join(sorted(r)) + ":" + str(sorted(r.items()))[:40])
def test_parse_spec_rejects_with_the_jax_code(req):
    def code(jobs, *_):
        with pytest.raises(ValueError) as e:
            jobs.parse_spec(dict(req))
        return str(e.value).partition("\n")[0]

    j, t = both(code)
    assert t == j and t in tjobs.ERROR_CODES


def test_parse_spec_names_an_unknown_workload():
    with pytest.raises(ValueError) as e:
        tjobs.parse_spec({"workload": "nope", **GOOD})
    assert str(e.value).partition("\n")[0] == "unknown_workload"


def test_parse_spec_corpus_cap_and_path(tmp_path):
    p = tmp_path / "c.txt"
    p.write_bytes(b"x y\n" * 100)

    def go(jobs, *_):
        spec, corpus = jobs.parse_spec({"path": str(p)}, max_corpus_bytes=1000)
        with pytest.raises(ValueError) as e:
            jobs.parse_spec({"path": str(p)}, max_corpus_bytes=10)
        return spec.fingerprint(), corpus, str(e.value).partition("\n")[0]

    j, t = both(go)
    assert t == j and t[2] == "corpus_too_large"


@pytest.mark.parametrize("ovr", [
    {}, CFG_OVR, dict(KCFG_OVR, sort_mode="bitonic"), dict(KCFG_OVR, sort_mode="fused"),
    {"table_size": 8192, "sort_mode": "hasht"},
])
def test_spec_fingerprints_equal_jax(ovr):
    req = {"config": ovr, "tenant": "x" * 80, "weight": 2, "deadline_s": 5,
           "max_attempts": 3, **GOOD}

    def go(jobs, *_):
        spec, _ = jobs.parse_spec(dict(req))
        return (spec.fingerprint(), spec.tenant, spec.weight, spec.deadline_s,
                spec.max_attempts, jobs.pairs_bytes([(b"ab", 1), (b"c", 2)]))

    j, t = both(go)
    assert t == j


def test_plan_spec_fingerprint_equals_jax():
    req = {"plan": tplan.tfidf_plan().to_doc(), **GOOD}
    assert tplan.tfidf_plan().canonical_json() == jplan.tfidf_plan().canonical_json()

    def go(jobs, *_):
        spec, _ = jobs.parse_spec(dict(req))
        return spec.workload, spec.plan, spec.plan_fingerprint(), spec.fingerprint()

    j, t = both(go)
    assert t == j and t[0] == "plan"


def test_job_public_and_deadline_equal_jax():
    def go(jobs, sched, cache, batch, Cfg):
        job = mk_job(jobs, Cfg, job_id="p")
        job.submitted_s = 10.0
        job.started_s = 10.5
        job.finished_s = 11.25
        return job.public(), job.deadline_mono(), job.expired(1e9)

    j, t = both(go)
    assert t == j and set(t[0]) >= {"placed_on", "shards", "attempts"}


# ------------------------------------------------------------ scheduler


def _drain(s, key=const_key):
    order = []
    while True:
        batch = s.next_batch(key, timeout=0.0)
        if not batch:
            return order
        order.append([j.job_id for j in batch])


def _script(name):
    """Scheduler scenarios of tests/test_serve.py as (calls, result)."""

    def fairness(jobs, sched, cache, batch, Cfg):
        s = sched.FairScheduler(max_queue=32, max_batch=1)
        for i in range(10):
            s.admit(mk_job(jobs, Cfg, "heavy", job_id=f"h{i}"))
        for i in range(2):
            s.admit(mk_job(jobs, Cfg, "light", job_id=f"l{i}"))
        return _drain(s), s.stats()

    def weighted(jobs, sched, cache, batch, Cfg):
        s = sched.FairScheduler(max_queue=64, max_batch=1)
        for i in range(12):
            s.admit(mk_job(jobs, Cfg, "fast", weight=2.0, job_id=f"f{i}"))
            s.admit(mk_job(jobs, Cfg, "slow", job_id=f"s{i}"))
        return _drain(s), s.stats()

    def coalesce(jobs, sched, cache, batch, Cfg):
        s = sched.FairScheduler(max_queue=16, max_batch=3)
        for tenant, bucket, jid in (("a", 1, "a1"), ("a", 4, "a-big"), ("b", 1, "b1"),
                                    ("c", 1, "c1"), ("c", 1, "c2")):
            s.admit(mk_job(jobs, Cfg, tenant, bucket=bucket, job_id=jid))
        popped = s.next_batches(lambda j: ("k", j.bucket), max_batches=3, timeout=0.0)
        return [[j.job_id for j in b] for b in popped], s.stats()

    def admission(jobs, sched, cache, batch, Cfg):
        s = sched.FairScheduler(max_queue=3, max_batch=1, tenant_quota=2)
        codes = []
        for tenant in ("hog", "hog", "hog", "polite", "x"):
            try:
                s.admit(mk_job(jobs, Cfg, tenant, job_id=tenant))
                codes.append("ok")
            except sched.AdmitReject as e:
                codes.append(e.code)
        s.count_rejection()
        zero = sched.FairScheduler(max_queue=4, max_batch=2, tenant_quota=0).tenant_quota
        s.stop()
        try:
            s.admit(mk_job(jobs, Cfg))
        except sched.AdmitReject as e:
            codes.append(e.code)
        return codes, zero, s.stats(), s.next_batch(const_key, timeout=0.0)

    def cancel_requeue_expire(jobs, sched, cache, batch, Cfg):
        s = sched.FairScheduler(max_queue=8, max_batch=2)
        a, b, c = (mk_job(jobs, Cfg, t, job_id=t) for t in "abc")
        a.spec = dataclasses.replace(a.spec, deadline_s=0.5)
        for j in (a, b, c):
            s.admit(j)
        out = [s.cancel("c").job_id, s.cancel("c")]
        out.append([j.job_id for j in s.expire(a.submitted_s + 1.0)])
        out.append(s.requeue(c, not_before=1e12))
        out.append((s.depth(), s.stats()["retrying"]))
        out.append(s.cancel("c").job_id)
        out.append(_drain(s))
        s.stop()
        out.append((s.requeue(c), s.drain()))
        return out, s.stats()

    def rejoin_and_prune(jobs, sched, cache, batch, Cfg):
        s = sched.FairScheduler(max_queue=64, max_batch=1)
        for i in range(12):
            s.admit(mk_job(jobs, Cfg, "a", bucket=8, job_id=f"a{i}"))
        first = _drain(s)
        for i in range(12):
            s.admit(mk_job(jobs, Cfg, "b", job_id=f"b{i}"))
        for i in range(4):
            s.admit(mk_job(jobs, Cfg, "a", job_id=f"r{i}"))
        second = _drain(s)
        for i in range(20):
            s.admit(mk_job(jobs, Cfg, f"tenant-{i}", job_id=f"t{i}"))
        return first, second, _drain(s), s.stats()

    return locals()[name]


@pytest.mark.parametrize("name", ["fairness", "weighted", "coalesce", "admission",
                                  "cancel_requeue_expire", "rejoin_and_prune"])
def test_scheduler_equals_jax(name):
    j, t = both(_script(name))
    assert t == j


def test_scheduler_fair_properties():
    order, _ = _script("fairness")(*PKGS["torch"])
    assert {"l0", "l1"} <= {b[0] for b in order[:4]}
    order, _ = _script("weighted")(*PKGS["torch"])
    assert sum(b[0].startswith("f") for b in order[:9]) >= 5
    popped, _ = _script("coalesce")(*PKGS["torch"])
    assert popped == [["a1", "b1", "c1"], ["a-big"], ["c2"]]


# ------------------------------------------------------- shapes, lines


def test_bucket_ladder_count_lines_and_job_shape_equal_jax():
    ns = (0, 1, 2, 3, 4, 5, 8, 9, 100, 1023, 1025)
    assert [tcache.bucket_blocks(n) for n in ns] == [jcache.bucket_blocks(n) for n in ns]
    rng = random.Random(7)
    cases = [b"", b"\n", b"a", b"a\r\nb\r\n", b"a\rb", b"\r\r", b"x\n\ry\r\nz"]
    cases += [bytes(rng.choice(b"ab \n\r") for _ in range(rng.randrange(60))) for _ in range(200)]
    for c in cases:
        assert tbatch.count_lines(c) == jbatch.count_lines(c) == len(c.splitlines()), c
    for n in (0, 1, 8, 9, 63, 64, 65, 4096 * 52):
        assert tbatch.job_shape(n, TCfg(**KCFG_OVR)) == jbatch.job_shape(n, JCfg(**KCFG_OVR))


# --------------------------------------------------------------- caches


def test_exec_cache_counters_lru_and_fused_state_equal_jax():
    def go(jobs, sched, cache, batch, Cfg):
        kw = {"device": "cpu"} if cache is tcache else {}
        ec = cache.ExecutableCache(max_engines=2, **kw)

        def spec(**ovr):
            return jobs.JobSpec(tenant="t", workload="wordcount", cfg=Cfg(**dict(CFG_OVR, **ovr)))

        s1, s2 = spec(), spec(emits_per_line=4)
        fused_on = spec(sort_mode="fused", block_lines=32, line_width=128)
        fused_off = spec(sort_mode="fused", block_lines=32, line_width=64)
        log = []
        eng, hit = ec.lookup(s1, 1, 1)
        log.append(hit)
        ec.mark_compiled(s1, 1, 1)
        eng2, hit = ec.lookup(s1, 1, 1)
        log += [hit, eng2 is eng]
        ec.mark_compiled(s1, 1, 4)
        log.append(ec.lookup(s1, 1, 4)[1])
        log.append(ec.lookup(s2, 2, 1)[1])
        ec.mark_compiled(s2, 2, 1)
        log.append(ec.warm_shapes())
        log.append(ec.lookup(fused_on, 1, 1)[1])  # evicts s1 and its shapes
        log.append(ec.stats())
        log.append(ec.lookup(fused_off, 1, 1)[1])
        log.append(ec.lookup_fold_node("n1", Cfg(**CFG_OVR), 1, 2)[1])
        ec.mark_compiled_fold_node("n1", Cfg(**CFG_OVR).fingerprint(), 1, 2)
        log.append(ec.lookup_fold_node("n1", Cfg(**CFG_OVR), 1, 2)[1])
        log.append(ec.stats())
        return log

    j, t = both(go)
    assert t == j
    assert t[7]["fused_on"] == 1 and t[7]["evictions"] == 1
    assert (t[-1]["fused_on"], t[-1]["fused_demoted"], t[-1]["evictions"]) == (0, 1, 3)


def test_result_cache_sequence_equals_jax():
    entry = [(b"k" * 20, 1)]

    def go(jobs, sched, cache, batch, Cfg):
        rc = cache.ResultCache(max_entries=3, max_bytes=100)
        log = [rc.put("d1", "f", entry), rc.put("d2", "f", [(b"b\x00\xff", 2)]),
               rc.put("d3", "f", entry, meta={"distinct": 1, "truncated": True})]
        log += [rc.get("d1", "f"), rc.get_with_meta("d3", "f"), rc.get("nope", "f")]
        log += [rc.stats(), rc.dump(), rc.invalidate(digest="d2"), rc.invalidate(spec_fp="g")]
        small = cache.ResultCache(max_entries=10, max_bytes=10)
        small.put("big", "f", entry)
        log += [small.get("big", "f"), rc.load(rc.dump() + [{"digest": "x"}]),
                rc.invalidate(), rc.stats()]
        return log

    j, t = both(go)
    assert t == j


def test_subplan_cache_sequence_equals_jax():
    def go(jobs, sched, cache, batch, Cfg):
        sc = cache.SubPlanCache(max_entries=3, max_bytes=100)
        for i, size in enumerate((10, 20, 30, 60)):
            sc.put(f"fp{i % 2}", "cfg", f"sha{i}", {"bytes": size, "corpus_len": i})
        log = [sc.get("fp0", "cfg", "sha2") is not None, sc.get("fp0", "cfg", "sha0")]
        log.append([e["corpus_len"] for e in sc.prefix_candidates("fp1", "cfg")])
        sc.record_incremental(3, 9)
        log += [sc.stats(), sc.invalidate(corpus_sha="sha3"), sc.invalidate(), sc.stats()]
        return log

    j, t = both(go)
    assert t == j


# ----------------------------------------------------- merge and demux


def test_merge_shard_results_equals_jax():
    rng = random.Random(3)
    words = [b"w%d" % i for i in range(40)] + [b"x" * 30]
    shards = [{"pairs": sorted({rng.choice(words): rng.randrange(1, 9) for _ in range(25)}.items()),
               "truncated": i == 2, "overflow_tokens": i} for i in range(3)]

    def go(jobs, sched, cache, batch, Cfg):
        kw = {"device": "cpu"} if batch is tbatch else {}
        cfg = Cfg(**dict(CFG_OVR, table_size=4096))
        return (batch.merge_shard_results(shards, cfg, **kw),
                batch.merge_shard_results([{"pairs": []}], cfg, **kw))

    j, t = both(go)
    assert t == j and t[0][2] is True and t[0][3] == 3


@pytest.mark.parametrize("ovr", [CFG_OVR, dict(KCFG_OVR, sort_mode="bitonic"),
                                 dict(KCFG_OVR, sort_mode="fused")],
                         ids=["hash", "bitonic", "fused"])
def test_stage_batch_run_batch_demux_equals_jax(ovr):
    """Three jobs (padded to four slots) in one bucket: each job's host
    pairs and counters equal the JAX dispatch's and a solo run's."""
    big = (CORPUS_A + CORPUS_B) * (ovr["block_lines"] // 8)
    corpora = {"a": big, "b": big[: len(big) // 2] + b"lone word\n", "c": CORPUS_B}

    def go(jobs, sched, cache, batch, Cfg):
        cfg = Cfg(**ovr)
        eng = TEngine(cfg, device="cpu") if batch is tbatch else JEngine(cfg)
        js = []
        for digest, corpus in corpora.items():
            n_blocks, _ = batch.job_shape(batch.count_lines(corpus), cfg)
            js.append(jobs.Job(job_id=digest, spec=jobs.JobSpec("t", "wordcount", cfg),
                               corpus_digest=digest, n_lines=0, n_blocks=n_blocks, bucket=4))
        stack = batch.stage_batch(eng, js, corpora)
        res = batch.dispatch_batch(eng, js, corpora)
        return (tuple(stack.shape),
                [(r.to_host_pairs(), int(r.num_segments), int(r.overflow_tokens),
                  bool(r.truncated)) for r in res])

    j, t = both(go)
    assert t == j and t[0] == (4, 4, ovr["block_lines"], ovr["line_width"])
    solo = TEngine(TCfg(**ovr), device="cpu")
    for (pairs, *_), corpus in zip(t[1], corpora.values()):
        assert pairs == solo.run_lines(corpus.splitlines()).to_host_pairs()
