"""PyTorch port, the serve daemon's durability tier against the JAX
daemon's: the write-ahead journal (replay under the original ids, its
records, compaction, torn appends), kill -9 of a daemon process, the
retry ladder (poison bisection, deadlines), journal failures and warm
restarts — tests/test_serve.py:966-1350, each on the port's daemon (on
the CPU) and, where the two must agree, on the JAX daemon too."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import pytest
from torch_serve_rig import (
    CFG_OVR,
    CORPUS_A,
    CORPUS_B,
    SECRET,
    abandon,
    error_view,
    oracle,
    result_view,
    start,
)

from locust_tpu.serve import ServeError as JError
from locust_tpu.utils import faultplan as jfaults
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.serve import ServeClient, ServeError
from locust_tpu_torch.serve.jobs import Job, JobSpec
from locust_tpu_torch.serve.journal import JobJournal
from locust_tpu_torch.utils import faultplan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = {"jax": jfaults, "torch": faultplan}
CFG = EngineConfig(**CFG_OVR)


def journal_daemon(pkg, jdir, **kw):
    return start(pkg, max_queue=16, max_batch=4, dispatch_poll_s=0.02,
                 journal_dir=str(jdir), retry_base_s=0.02, **kw)


def mk(job_id, corpus):
    return Job(job_id=job_id, spec=JobSpec(tenant="t", workload="wordcount", cfg=CFG),
               corpus_digest=hashlib.sha256(corpus).hexdigest(),
               n_lines=1, n_blocks=1, bucket=1, config_overrides={}), corpus


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_journal_replay_reenqueues_under_original_ids(pkg, tmp_path):
    """Acked, never dispatched, then kill -9: the restart answers both
    jobs under their ids, exactly; a clean close compacts the journal
    to nothing and collects the spills.  The records written are the
    same in both packages but for the ids and clocks."""
    jdir = tmp_path / "journal"
    d, c = journal_daemon(pkg, jdir)
    d.scheduler.pause()
    ja = c.submit(corpus=CORPUS_A, config=CFG_OVR, tenant="x", deadline_s=60)["job_id"]
    jb = c.submit(corpus=CORPUS_B, config=CFG_OVR, max_attempts=2)["job_id"]
    records = [json.loads(x) for x in (jdir / "journal.jsonl").read_text().splitlines()]
    abandon(d)
    d2, c2 = journal_daemon(pkg, jdir)
    try:
        assert dict(c2.wait(ja, timeout=60.0)["pairs"]) == oracle(CORPUS_A)
        assert dict(c2.wait(jb, timeout=60.0)["pairs"]) == oracle(CORPUS_B)
        assert c2.stats()["journal"]["appends"] >= 2
    finally:
        d2.close()
    assert (jdir / "journal.jsonl").read_bytes() == b""
    assert list((jdir / "corpus").glob("*.bin")) == []
    for r in records:
        r.pop("job_id"), r.pop("t")
    assert records == [
        {"rec": "admit", "v": 1, "tenant": "x", "workload": "wordcount", "config": CFG_OVR,
         "weight": 1.0, "no_cache": False, "deadline_s": 60.0, "max_attempts": 4,
         "corpus_sha": hashlib.sha256(CORPUS_A).hexdigest(), "n_lines": 12},
        {"rec": "admit", "v": 1, "tenant": "default", "workload": "wordcount",
         "config": CFG_OVR, "weight": 1.0, "no_cache": False, "deadline_s": None,
         "max_attempts": 2, "corpus_sha": hashlib.sha256(CORPUS_B).hexdigest(), "n_lines": 12},
    ]


def test_replay_done_job_restored_from_warm_state(tmp_path):
    kw = dict(warm_dir=str(tmp_path / "warm"), warm_every=1)
    d, c = journal_daemon("torch", tmp_path / "j", **kw)
    ack = c.submit(corpus=CORPUS_A, config=CFG_OVR)
    assert dict(c.wait(ack["job_id"], timeout=60.0)["pairs"]) == oracle(CORPUS_A)
    d.warm.flush()
    abandon(d)
    d2, c2 = journal_daemon("torch", tmp_path / "j", **kw)
    try:
        r2 = c2.result(ack["job_id"])
        assert dict(r2["pairs"]) == oracle(CORPUS_A) and r2["cache"] == "result"
    finally:
        d2.close()


def _spawn(jdir, env):
    proc = subprocess.Popen(
        [sys.executable, "-m", "locust_tpu_torch.serve", "--port", "0",
         "--journal-dir", str(jdir), "--backend", "cpu"],
        env=env, stderr=subprocess.PIPE, text=True,
    )
    line = proc.stderr.readline()
    assert "listening on" in line, line
    host, _, port = line.rsplit(" ", 1)[1].strip().partition(":")
    return proc, (host, int(port))


def test_sigkill_daemon_process_restart_replays_byte_identical(tmp_path):
    """The real thing: ``python -m locust_tpu_torch.serve`` is SIGKILL'd
    right behind its acks; a fresh daemon on the same journal answers
    every job exactly."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "LOCUST_SECRET": SECRET.decode()}
    jdir = tmp_path / "journal"
    corpora = (CORPUS_A, CORPUS_B, CORPUS_A + CORPUS_B)
    proc, addr = _spawn(jdir, env)
    try:
        client = ServeClient(addr, SECRET, timeout=30.0)
        ids = [client.submit(corpus=x, config=CFG_OVR, no_cache=True)["job_id"]
               for x in corpora]
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
    proc2, addr2 = _spawn(jdir, env)
    try:
        c2 = ServeClient(addr2, SECRET, timeout=30.0)
        for jid, x in zip(ids, corpora):
            assert dict(c2.wait(jid, timeout=120.0)["pairs"]) == oracle(x)
        c2.shutdown()
        proc2.wait(timeout=30)
    finally:
        if proc2.poll() is None:
            proc2.kill()
        proc2.stderr.close()
        proc.stderr.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_poison_job_bisection_quarantines_only_the_poison(pkg):
    fp = FAULTS[pkg]
    d, c = start(pkg, max_queue=16, max_batch=4, dispatch_poll_s=0.02, retry_base_s=0.01)
    try:
        d.scheduler.pause()
        corpora = [CORPUS_A, CORPUS_B, CORPUS_A * 2, CORPUS_B * 2]
        ids = [c.submit(corpus=x, config=CFG_OVR, no_cache=True)["job_id"] for x in corpora]
        poison = ids[1]
        p = fp.FaultPlan([{"site": "serve.dispatch", "action": "error",
                           "match": {"job": poison}}], seed=3)
        with fp.active_plan(p):
            d.scheduler.resume()
            for jid, x in zip(ids, corpora):
                if jid == poison:
                    with pytest.raises((ServeError, JError)) as e:
                        c.wait(jid, timeout=60.0)
                    assert e.value.code == "poison_job"
                else:
                    assert dict(c.wait(jid, timeout=60.0)["pairs"]) == oracle(x)
        st = c.status(poison)
        assert (st["state"], st["attempts"], st["max_attempts"]) == ("failed", 4, 4)
        assert p.rules[0].fired >= 2
    finally:
        d.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_deadlines_expire_structured_in_queue_and_at_retry(pkg):
    fp = FAULTS[pkg]
    d, c = start(pkg, max_queue=8, max_batch=2, dispatch_poll_s=0.02, retry_base_s=30.0)
    try:
        d.scheduler.pause()
        ack = c.submit(corpus=CORPUS_A, config=CFG_OVR, deadline_s=0.2, no_cache=True)
        with pytest.raises((ServeError, JError)) as e:
            c.wait(ack["job_id"], timeout=30.0)
        st = c.status(ack["job_id"])
        assert (e.value.code, st["state"], st["error"]["code"]) == (
            "deadline_exceeded", "failed", "deadline_exceeded")
        d.scheduler.resume()
        p = fp.FaultPlan([{"site": "serve.dispatch", "action": "error", "times": 1}], seed=3)
        with fp.active_plan(p):
            ack = c.submit(corpus=CORPUS_B, config=CFG_OVR, deadline_s=5.0, no_cache=True)
            with pytest.raises((ServeError, JError)) as e:
                c.wait(ack["job_id"], timeout=30.0)
        assert e.value.code == "deadline_exceeded" and p.rules[0].fired == 1
    finally:
        d.close()


def test_wait_timeout_error_reports_state_and_attempts():
    d, c = start("torch", max_queue=8, max_batch=4, dispatch_poll_s=0.02)
    try:
        d.scheduler.pause()
        ack = c.submit(corpus=CORPUS_A, config=CFG_OVR, no_cache=True)
        with pytest.raises(TimeoutError) as e:
            c.wait(ack["job_id"], timeout=0.4, poll_s=0.02)
        assert "queued" in str(e.value) and "attempt 0/4" in str(e.value)
        d.scheduler.resume()
    finally:
        d.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_journal_failures_reject_structured_without_residue(pkg, tmp_path, monkeypatch):
    """An injected torn append answers fault_injected, a real append
    failure journal_failed; neither leaves a job behind."""
    fp = FAULTS[pkg]
    d, c = journal_daemon(pkg, tmp_path / "j")
    try:
        with fp.active_plan(fp.FaultPlan(
                [{"site": "serve.journal", "action": "crash", "times": 1}], seed=7)):
            with pytest.raises((ServeError, JError)) as e1:
                c.submit(corpus=CORPUS_A, config=CFG_OVR, no_cache=True)

        def boom(job, corpus):
            raise OSError("disk full")

        monkeypatch.setattr(d.journal, "append_admit", boom)
        with pytest.raises((ServeError, JError)) as e2:
            c.submit(corpus=CORPUS_B, config=CFG_OVR, no_cache=True)
        monkeypatch.undo()
        assert (error_view(e1.value)[0], error_view(e2.value)[0]) == (
            "fault_injected", "journal_failed")
        ack = c.submit(corpus=CORPUS_B, config=CFG_OVR, no_cache=True)
        assert dict(c.wait(ack["job_id"], timeout=60.0)["pairs"]) == oracle(CORPUS_B)
        assert c.stats()["jobs_by_state"] == {"done": 1}
    finally:
        d.close()


def test_journal_compaction_never_drops_concurrent_admit(tmp_path):
    j = JobJournal(str(tmp_path / "j"))
    done_job, done_corpus = mk("done0", b"aa bb\n")
    j.append_admit(done_job, done_corpus)
    j.append_state("done0", "done")
    live_job, live_corpus = mk("live0", b"cc dd\n")
    j.append_admit(live_job, live_corpus)
    assert j.stats()["live"] == 1
    j.compact()
    entries = {e.admit["job_id"]: e for e in j.replay()}
    assert list(entries) == ["live0"] and entries["live0"].terminal is None
    assert j.read_spill(live_job.corpus_digest) == live_corpus
    assert j.read_spill(done_job.corpus_digest) is None
    j.append_state("live0", "done")
    j.append_admit(live_job, live_corpus)
    j.compact()
    assert [e.admit["job_id"] for e in j.replay()] == ["live0"]
    with pytest.raises(ValueError):
        j.append_state("live0", "running")
    j.close()


def test_journal_torn_append_does_not_glue_next_record(tmp_path):
    doomed, doomed_corpus = mk("torn0", b"aa bb\n")
    survivor, survivor_corpus = mk("live1", b"cc dd\n")
    for restart in (False, True):
        j = JobJournal(str(tmp_path / f"j{restart}"))
        with faultplan.active_plan(faultplan.FaultPlan(
                [{"site": "serve.journal", "action": "crash", "times": 1}], seed=7)):
            with pytest.raises(faultplan.FaultCrash):
                j.append_admit(doomed, doomed_corpus)
        if restart:
            j.close()
            j = JobJournal(str(tmp_path / f"j{restart}"))  # inherits the torn tail
        j.append_admit(survivor, survivor_corpus)
        assert "live1" in {e.admit["job_id"] for e in j.replay()}
        j.close()


@pytest.mark.parametrize("seed", range(4))
def test_journal_corrupt_records_replay_as_in_jax(seed, tmp_path):
    """Silently mangled records: the JAX journal's replay of the port's
    file keeps and drops exactly what the port's replay does."""
    from locust_tpu.serve.journal import JobJournal as JJournal

    j = JobJournal(str(tmp_path / "j"))
    jobs = [mk(f"job{i}", b"w%d\n" % i) for i in range(4)]
    with faultplan.active_plan(faultplan.FaultPlan(
            [{"site": "serve.journal", "action": "corrupt", "prob": 0.5}], seed=seed)):
        for job, corpus in jobs:
            j.append_admit(job, corpus)
            j.append_state(job.job_id, "done")
    j.close()
    theirs = JJournal(str(tmp_path / "j"))
    mine = JobJournal(str(tmp_path / "j"))
    assert ([(e.admit, e.terminal) for e in mine.replay()]
            == [(e.admit, e.terminal) for e in theirs.replay()])
    theirs.close()
    mine.close()


def test_cancelled_job_replays_cancelled_code_across_restart(tmp_path):
    d, c = journal_daemon("torch", tmp_path / "j")
    d.scheduler.pause()
    jid = c.submit(corpus=CORPUS_A, config=CFG_OVR, no_cache=True)["job_id"]
    assert c.cancel(jid)["cancelled"] is True
    abandon(d)
    d2, c2 = journal_daemon("torch", tmp_path / "j")
    try:
        with pytest.raises(ServeError) as e:
            c2.result(jid)
        assert e.value.code == "cancelled" and c2.status(jid)["state"] == "cancelled"
    finally:
        d2.close()


def test_warm_state_survives_restart_and_cadence_is_distance_based(tmp_path):
    kw = dict(max_queue=8, max_batch=4, dispatch_poll_s=0.02,
              warm_dir=str(tmp_path / "w"), warm_every=3)
    d, c = start("torch", **kw)
    try:
        for wave in range(2):  # completed observes 2, then 4: never % 3 == 0
            d.scheduler.pause()
            acks = [c.submit(corpus=b"wave%d job%d\n" % (wave, i) * 4, config=CFG_OVR)
                    for i in range(2)]
            d.scheduler.resume()
            for a in acks:
                c.wait(a["job_id"], timeout=60.0)
        assert d.warm.stats()["submitted"] >= 1
        first = result_view(c.wait(c.submit(corpus=CORPUS_A, config=CFG_OVR)["job_id"]))
    finally:
        d.close()
    d2, c2 = start("torch", **kw)
    try:
        ack = c2.submit(corpus=CORPUS_A, config=CFG_OVR)
        again = result_view(c2.result(ack["job_id"]))
        assert ack["cached"] is True and again == dict(first, cache="result")
    finally:
        d2.close()


def test_fail_batch_preserves_already_done_jobs():
    d, _ = start("torch")
    try:
        done_job, _ = mk("d1", b"x\n")
        pending, _ = mk("p1", b"y\n")
        done_job.state = "done"
        from locust_tpu_torch.serve.jobs import structured_error

        d._fail_batch([done_job, pending], structured_error("dispatch_failed", "boom"))
        assert done_job.state == "done" and done_job.error is None
        assert (pending.state, pending.error["code"]) == ("failed", "dispatch_failed")
    finally:
        d.close()


def test_daemon_without_a_card_raises_at_start(monkeypatch):
    """The daemon resolves CUDA at construction: no card is an error at
    start (here, where torch has no CUDA), never a dispatch-time one."""
    import torch

    from locust_tpu_torch.serve import ServeDaemon
    from locust_tpu_torch.serve import __main__ as serve_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeDaemon(secret=SECRET)
    monkeypatch.setenv("LOCUST_SECRET", "s")
    t0 = time.monotonic()
    assert serve_main.main(["--port", "0"]) == 2
    assert time.monotonic() - t0 < 30


def test_daemon_process_trace_out_records_the_serve_spans(tmp_path):
    """``--trace-out``: the daemon's Chrome trace, written at shutdown,
    holds the serve.* spans of a job's phases and the cache metrics, and
    is valid under the port's trace schema."""
    from locust_tpu_torch.obs.schema import validate_trace

    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "LOCUST_SECRET": SECRET.decode()}
    trace = tmp_path / "serve.trace.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "locust_tpu_torch.serve", "--port", "0", "--backend", "cpu",
         "--trace-out", str(trace)], env=env, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        port = int(line.rsplit(":", 1)[1])
        c = ServeClient(("127.0.0.1", port), SECRET, timeout=30.0)
        for _ in range(2):
            ack = c.submit(corpus=CORPUS_A, config=CFG_OVR, no_cache=True)
            assert dict(c.wait(ack["job_id"], timeout=60.0)["pairs"]) == oracle(CORPUS_A)
        c.shutdown()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stderr.close()
    doc = json.loads(trace.read_text())
    validate_trace(doc)
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"serve.compile_or_hit", "serve.dispatch", "serve.demux"} <= names
    counters = doc["otherData"]["metrics"]["counters"]
    assert (counters["serve.exec_cache_misses"], counters["serve.exec_cache_hits"],
            counters["serve.jobs"]) == (1, 1, 2)


def test_daemon_on_cuda_builds_the_kernels_at_start(monkeypatch):
    """With a card the daemon builds and loads every kernel library at
    construction, before it answers anything."""
    import torch

    from locust_tpu_torch import _build
    from locust_tpu_torch.serve import ServeDaemon

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build", lambda: calls.append("build") or {})
    monkeypatch.setattr(_build, "load", lambda name: calls.append(name))
    d = ServeDaemon(secret=SECRET)
    try:
        assert d.device.type == "cuda" and d.executables.device == d.device
        assert calls == ["build", *_build.KERNEL_SOURCES]
    finally:
        d.close()
