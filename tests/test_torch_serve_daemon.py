"""PyTorch port, the serve daemon's command protocol against the JAX
daemon's: the roundtrips of tests/test_serve.py, each run through a JAX
daemon and a port daemon (on the CPU) under the same config and the same
submits.  Results, structured error codes, cache answers and every stats
counter agree exactly, and the pairs equal the oracle."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import re
import socket
import time

import pytest
from torch_serve_rig import (
    CFG_OVR,
    CORPUS_A,
    CORPUS_B,
    KCFG_OVR,
    SECRET,
    error_view,
    key_tree,
    oracle,
    pair,
    result_view,
    start,
    stats_view,
)

from locust_tpu import cli as jcli
from locust_tpu.distributor import protocol as jprotocol
from locust_tpu.serve import ServeError as JError
from locust_tpu.serve import __main__ as jserve_main
from locust_tpu_torch import cli as tcli
from locust_tpu_torch.distributor import protocol as tprotocol
from locust_tpu_torch.serve import ServeError as TError
from locust_tpu_torch.serve import __main__ as tserve_main
from locust_tpu_torch.serve.daemon import ServeConfig

RIG = dict(max_queue=8, max_batch=4, warm_every=1, dispatch_poll_s=0.02)


def both(fn, rigs):
    """``fn(daemon, client)`` on the JAX rig then the port rig."""
    return [fn(d, c) for d, c in rigs]


def run_job(client, corpus, daemon=None, **kw):
    """Submit and wait.  With ``daemon``, a cacheable job is waited for
    until its result is in the daemon's result cache too: the JAX daemon
    flips a job to "done" before its dispatcher puts the result there,
    so a client that resubmits at once can miss it under load."""
    ack = client.submit(corpus=corpus, config=kw.pop("config", CFG_OVR), **kw)
    if ack["cached"]:
        return ack, client.result(ack["job_id"])
    res = client.wait(ack["job_id"], timeout=120.0)
    if daemon is not None and not kw.get("no_cache"):
        published(daemon, ack["job_id"])
    return ack, res


def published(daemon, job_id, timeout=30.0):
    """Wait until the finished job's result is in the daemon's result
    cache (both packages key it by corpus digest and spec fingerprint)."""
    job = daemon._jobs[job_id]
    key = (job.corpus_digest, job.spec.fingerprint())
    deadline = time.monotonic() + timeout
    while key not in daemon.results._entries:
        assert time.monotonic() < deadline, f"{job_id} never reached the result cache"
        time.sleep(0.005)


def outcome(fn, client):
    """``fn(client)``'s reply, or the structured error it raised."""
    try:
        return fn(client)
    except (JError, TError) as e:
        return error_view(e)


@pytest.fixture
def rigs(tmp_path):
    with pair(jax_kw={"warm_dir": str(tmp_path / "jw")},
              torch_kw={"warm_dir": str(tmp_path / "tw")}, **RIG) as r:
        yield r


def test_submit_result_roundtrip_and_repeat_hits_result_cache(rigs):
    def go(d, c):
        a1, r1 = run_job(c, CORPUS_A, d)
        a2, r2 = run_job(c, CORPUS_A, d)
        st = c.status(a1["job_id"])
        assert st["latency_ms"] is not None and st["queue_ms"] is not None
        return (a1["cached"], a2["cached"], result_view(r1), result_view(r2),
                stats_view(c.stats()))

    j, t = both(go, rigs)
    assert t == j
    assert dict(t[2]["pairs"]) == oracle(CORPUS_A)
    assert (t[2]["cache"], t[3]["cache"]) == ("cold", "result")


def test_result_cache_replays_truncation_flags(rigs):
    lossy = b"a b c d e f g h i j k l m\n" * 4  # 13 tokens > cap of 8

    def go(d, c):
        return [result_view(run_job(c, lossy, d)[1]) for _ in range(2)]

    j, t = both(go, rigs)
    assert t == j and t[0]["overflow_tokens"] > 0
    assert t[1]["cache"] == "result" and t[1]["pairs"] == t[0]["pairs"]


def test_batches_compatible_jobs_and_demuxes(rigs):
    corpora = [CORPUS_A, CORPUS_B, CORPUS_A + b"delta extra words\n"]

    def go(d, c):
        d.scheduler.pause()
        acks = [c.submit(corpus=x, config=CFG_OVR) for x in corpora]
        d.scheduler.resume()
        res = [result_view(c.wait(a["job_id"], timeout=120.0)) for a in acks]
        sizes = [c.status(a["job_id"])["batch_size"] for a in acks]
        return res, sizes, stats_view(c.stats())

    j, t = both(go, rigs)
    assert t == j and t[1] == [3, 3, 3]
    assert [dict(r["pairs"]) for r in t[0]] == [oracle(x) for x in corpora]


def test_second_identical_job_is_a_warm_hit(rigs):
    def go(d, c):
        r1 = run_job(c, CORPUS_A, no_cache=True)[1]
        before = c.stats()["exec_cache"]
        r2 = run_job(c, CORPUS_A, no_cache=True)[1]
        return r1["cache"], r2["cache"], before, c.stats()["exec_cache"]

    j, t = both(go, rigs)
    assert t == j and t[:2] == ("cold", "warm")
    assert t[3]["compiles"] == t[2]["compiles"] and t[3]["hits"] == t[2]["hits"] + 1


def test_explicit_invalidation_and_unknown_job_invalidate(rigs):
    def go(d, c):
        a1, _ = run_job(c, CORPUS_A, d)
        bad = c.rpc({"cmd": "invalidate", "job_id": "no-such-id"})
        cached = c.submit(corpus=CORPUS_A, config=CFG_OVR)["cached"]
        n = c.invalidate(job_id=a1["job_id"])
        _, r = run_job(c, CORPUS_A, d)
        fresh = run_job(c, CORPUS_A, d, invalidate=True)[1]
        return ((bad["status"], bad["code"]), cached, n, result_view(r),
                result_view(fresh), stats_view(c.stats()))

    j, t = both(go, rigs)
    assert t == j and t[0] == ("error", "unknown_job") and t[1] is True
    assert t[3]["cache"] == "warm" and t[4]["cache"] == "warm"


def test_admission_bounds_buffered_corpus_bytes(rigs):
    def go(d, c):
        d.cfg.max_queue_bytes = 16
        err = outcome(lambda c: c.submit(corpus=CORPUS_A, config=CFG_OVR,
                                         no_cache=True), c)
        d.cfg.max_queue_bytes = 256 << 20
        _, r = run_job(c, CORPUS_A, no_cache=True)
        st = c.stats()
        return err, result_view(r), st["queue"]["rejected"], st["queued_corpus_bytes"]

    j, t = both(go, rigs)
    assert t == j and t[0][0] == "queue_full" and t[2:] == (1, 0)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_oversized_reply_is_structured_result_too_large(pkg, monkeypatch):
    protocol = jprotocol if pkg == "jax" else tprotocol
    d, _ = start(pkg, **RIG)
    monkeypatch.setattr(protocol, "MAX_FRAME", 4096)
    a, b = socket.socketpair()
    try:
        big = {"status": "ok", "pairs": [["k" * 64, 1]] * 500}
        assert d._try_reply(a, big) is True
        b.settimeout(5.0)
        reply = protocol.recv_frame(b, SECRET)
        assert (reply["status"], reply["code"]) == ("error", "result_too_large")
    finally:
        a.close()
        b.close()
        d.close()


def test_admission_rejects_structured_queue_full_and_tenant_quota():
    def go(d, c):
        d.scheduler.pause()
        codes = [outcome(lambda c, i=i: c.submit(
            corpus=b"q%d\n" % i, config=CFG_OVR, tenant="hog")["state"], c)
            for i in range(4)]
        codes.append(outcome(lambda c: c.submit(
            corpus=b"other\n", config=CFG_OVR, tenant="polite")["state"], c))
        q = c.stats()["queue"]
        return codes, q["rejected"], q["pending_by_tenant"]

    with pair(max_queue=3, tenant_quota=2, max_batch=4, dispatch_poll_s=0.02) as rigs:
        j, t = both(go, rigs)
    assert t == j
    assert [x if isinstance(x, str) else x[0] for x in t[0]] == [
        "queued", "queued", "tenant_quota", "tenant_quota", "queued"]


def test_rejects_oversized_corpus_inline_and_by_path(rigs, tmp_path):
    big = tmp_path / "big.txt"
    big.write_bytes(b"x " * 2048)

    def go(d, c):
        d.cfg.max_corpus_bytes = 1024
        inline = outcome(lambda c: c.submit(corpus=b"y " * 1024), c)
        path = outcome(lambda c: c.submit(path=str(big)), c)
        return inline, path

    j, t = both(go, rigs)
    assert t == j and t == (("corpus_too_large", "error", None),) * 2


def test_unknown_job_command_not_done_and_cancel(rigs):
    def go(d, c):
        out = [outcome(lambda c: c.status("nope"), c),
               outcome(lambda c: c.result("nope"), c),
               (lambda r: (r["status"], r["code"]))(c.rpc({"cmd": "bogus"}))]
        d.scheduler.pause()
        a = c.submit(corpus=CORPUS_A, config=CFG_OVR, no_cache=True)
        out.append(outcome(lambda c: c.result(a["job_id"]), c))
        cancel = c.cancel(a["job_id"])
        out.append((cancel["cancelled"], cancel["state"]))
        out.append(outcome(lambda c: c.result(a["job_id"]), c))
        out.append(c.status(a["job_id"])["state"])
        d.scheduler.resume()
        out.append(stats_view(c.stats()))
        return out

    j, t = both(go, rigs)
    assert t == j
    assert [x[0] for x in t[:4]] == ["unknown_job", "unknown_job", "error", "not_done"]
    assert t[4] == (True, "cancelled") and t[5][0] == "cancelled"


def test_stats_shape_and_ha_commands_answer_like_a_jax_daemon(rigs):
    def go(d, c):
        promote = c.rpc({"cmd": "promote"})
        ship = c.rpc({"cmd": "ship", "records": []})
        return (key_tree(c.stats()), (promote["status"], promote["code"]),
                promote["error"], (ship["status"], ship["code"]), ship["error"])

    j, t = both(go, rigs)
    assert t == j
    assert t[2] == "promote refused: this daemon is already the primary (epoch 1)"


def test_close_fails_stranded_queued_jobs_structured():
    def go(d, c):
        d.scheduler.pause()
        ids = [c.submit(corpus=x, config=CFG_OVR)["job_id"] for x in (CORPUS_A, CORPUS_B)]
        d.close()
        return [(d._jobs[i].state, d._jobs[i].error["code"]) for i in ids]

    with pair(**RIG) as rigs:
        j, t = both(go, rigs)
    assert t == j == [("failed", "shutting_down")] * 2


def test_rejected_submit_with_invalidate_preserves_cache():
    def go(d, c):
        run_job(c, CORPUS_A, d)
        d.scheduler.pause()
        fill = c.submit(corpus=b"fill\n", config=CFG_OVR)["job_id"]
        err = outcome(lambda c: c.submit(corpus=CORPUS_A, config=CFG_OVR,
                                         invalidate=True), c)
        hit = c.submit(corpus=CORPUS_A, config=CFG_OVR)["cached"]
        d.scheduler.resume()
        # The queued job runs once resumed: the counters are read after
        # its result is cached, not while it races the stats request.
        c.wait(fill, timeout=120.0)
        published(d, fill)
        return err, hit, stats_view(c.stats())["result_cache"]

    with pair(max_queue=1, max_batch=4, dispatch_poll_s=0.02) as rigs:
        j, t = both(go, rigs)
    assert t == j and t[0][0] == "queue_full" and t[1] is True


def test_history_byte_cap_evicts_oldest_finished():
    corpora = [b"w%d alpha beta\n" % i * 3 for i in range(4)]

    def go(d, c):
        ids = [run_job(c, x, no_cache=True)[0]["job_id"] for x in corpora]
        return ([outcome(lambda c, i=i: c.status(i)["state"], c) for i in ids],
                c.stats()["history_result_bytes"])

    with pair(max_history_bytes=100, **RIG) as rigs:
        j, t = both(go, rigs)
    assert t == j and t[0][-1] == "done" and t[0][0][0] == "unknown_job"


def test_mixed_tenant_stream_all_exact(rigs):
    jobs = [(f"t{i % 3}", CORPUS_A * (1 + i % 2) + b"tail%d\n" % i) for i in range(9)]

    def go(d, c):
        acks = [c.submit(corpus=x, config=CFG_OVR, tenant=tn, weight=1 + i % 2)
                for i, (tn, x) in enumerate(jobs)]
        res = [result_view(c.wait(a["job_id"], timeout=120.0)) for a in acks]
        return res, stats_view(c.stats())["exec_cache"]

    j, t = both(go, rigs)
    assert [r["pairs"] for r in t[0]] == [r["pairs"] for r in j[0]]
    assert [dict(r["pairs"]) for r in t[0]] == [oracle(x) for _, x in jobs]


@pytest.mark.parametrize("mode", ["bitonic", "fused", "hasht"])
def test_kernel_sort_modes_answer_the_oracle(mode):
    """Under the kernels' sort modes (their plain versions on the CPU)
    the port daemon's pairs are the oracle's; a fused engine is counted
    in ``fused_on`` as the JAX daemon counts it."""
    d, c = start("torch", **RIG)
    try:
        cfg = dict(KCFG_OVR, sort_mode=mode)
        _, r1 = run_job(c, CORPUS_A * 30, config=cfg)
        _, r2 = run_job(c, CORPUS_B * 30, config=cfg)
        assert dict(r1["pairs"]) == oracle(CORPUS_A * 30)
        assert dict(r2["pairs"]) == oracle(CORPUS_B * 30)
        assert (r1["cache"], r2["cache"]) == ("cold", "warm")
        assert c.stats()["exec_cache"]["fused_on"] == (mode == "fused")
    finally:
        d.close()


def test_cli_submit_no_wait_then_result(tmp_path, capsysbinary):
    """The serve CLIs of both packages, each against its own daemon:
    ``submit --no-wait`` prints the id, ``result --wait`` the table —
    bytes equal to each other and to the one-shot CLIs'."""
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(CORPUS_A + CORPUS_B)
    widths = ["--block-lines", "8", "--line-width", "64", "--key-width", "16",
              "--emits-per-line", "8"]
    outs = []
    with pair(**RIG) as ((jd, _), (td, _)):
        for main, d in ((jserve_main.main, jd), (tserve_main.main, td)):
            port = ["--port", str(d.addr[1]), "--secret-env", "LOCUST_TEST_SECRET"]
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("LOCUST_TEST_SECRET", SECRET.decode())
                capsysbinary.readouterr()
                assert main(["submit", str(corpus), "--no-wait", *port, *widths]) == 0
                job = capsysbinary.readouterr().out.decode().strip()
                assert main(["result", job, "--wait", *port]) == 0
                outs.append(capsysbinary.readouterr().out)
    one_shot = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--backend", "cpu"])):
        capsysbinary.readouterr()
        assert main([str(corpus), *widths, "--no-timing", *extra]) == 0
        one_shot.append(capsysbinary.readouterr().out)
    assert outs[0] == outs[1] == one_shot[0] == one_shot[1]
    rows = dict(line.split(b"\t") for line in outs[1].splitlines())
    assert {k: int(v) for k, v in rows.items()} == oracle(CORPUS_A + CORPUS_B)


def test_slice_10_configs_and_flags_refuse(capsys, monkeypatch, tmp_path):
    """The scale-out and HA configs and flags, refused before this slice,
    now construct and start as the JAX daemon's do: the same
    ``ServeConfig`` fields, the same ``--journal-dir`` refusal for
    ``--ship-to``/``--standby-of`` without one, a daemon per flag set
    with the same role line, and ``promote`` answering as JAX's does."""
    import dataclasses

    from locust_tpu.serve import ServeConfig as JConfig
    from locust_tpu.serve import ServeDaemon as JDaemon
    from locust_tpu_torch.serve import ServeDaemon as TDaemon

    for kw in ({"workers": ("127.0.0.1:1",)}, {"ship_to": "h:1"}, {"standby_of": "h:1"}):
        assert dataclasses.asdict(ServeConfig(**kw)) == dataclasses.asdict(JConfig(**kw))
    monkeypatch.setenv("LOCUST_SECRET", SECRET.decode())
    with pair(jax_kw={"journal_dir": str(tmp_path / "jp")},
              torch_kw={"journal_dir": str(tmp_path / "tp")}) as ((jp, _), (tp, _)):
        answers = []
        for main, d in ((jserve_main.main, jp), (tserve_main.main, tp)):
            rc = main(["promote", "--port", str(d.addr[1])])
            answers.append((rc, capsys.readouterr().err))
        assert answers[0] == answers[1]
        assert answers[1][0] == 1 and "[bad_spec] promote refused" in answers[1][1]
    built = []
    for cls in (JDaemon, TDaemon):
        monkeypatch.setattr(cls, "serve_forever", lambda self: (built.append(self), self.close()))
    for argv in (["--ship-to", "127.0.0.1:1"], ["--standby-of", "127.0.0.1:1"]):
        errs = []
        for main in (jserve_main.main, tserve_main.main):  # refused before the device
            assert main(["--port", "0", *argv]) == 2
            errs.append(capsys.readouterr().err)
        assert errs[0] == errs[1] and "--journal-dir" in errs[1]
    for i, argv in enumerate((["--workers", "127.0.0.1:1", "--shard-min-blocks", "4"],
                              ["--ship-to", "127.0.0.1:1"],
                              ["--standby-of", "127.0.0.1:1", "--lease", "3"])):
        lines = []
        for pkg, main, extra in (("jax", jserve_main.main, []),
                                 ("torch", tserve_main.main, ["--backend", "cpu"])):
            jdir = ["--journal-dir", str(tmp_path / f"{pkg}{i}")] if i else []
            assert main(["--port", "0", *argv, *jdir, *extra]) == 0
            lines.append(re.sub(r":\d+", ":P", next(
                ln for ln in capsys.readouterr().err.splitlines() if "listening on" in ln)))
        assert lines[0] == lines[1] == "[serve] listening on 127.0.0.1:P" + (
            "", " (role primary)", " (role standby)")[i]
    jd, td = built[0::2], built[1::2]
    for j, t in zip(jd, td):
        assert dataclasses.asdict(t.cfg) | {"journal_dir": None} == \
            dataclasses.asdict(j.cfg) | {"journal_dir": None}
        assert t.role == j.role
    assert td[0].pool is not None and td[0].cfg.shard_min_blocks == 4
    assert td[2].role == "standby" and td[2].cfg.lease_s == 3.0


def test_admission_fault_site_answers_like_jax():
    """``serve.admit``: an "error" rule rejects the submit with the
    structured ``fault_injected`` code, a "delay" rule only slows it."""
    from locust_tpu.utils import faultplan as jfaults
    from locust_tpu_torch.utils import faultplan as tfaults

    def go(fp, d, c):
        rules = [{"site": "serve.admit", "action": "error", "times": 1},
                 {"site": "serve.admit", "action": "delay", "delay_s": 0.01, "times": 1}]
        with fp.active_plan(fp.FaultPlan(rules, seed=5)) as plan:
            err = outcome(lambda c: c.submit(corpus=CORPUS_A, config=CFG_OVR), c)
            ok = result_view(run_job(c, CORPUS_A)[1])
            fired = [r.fired for r in plan.rules]
        return err, ok, fired, stats_view(c.stats())["queue"]

    with pair(**RIG) as ((jd, jc), (td, tc)):
        j, t = go(jfaults, jd, jc), go(tfaults, td, tc)
    assert t == j and t[0][0] == "fault_injected" and t[2] == [1, 1]


def test_cli_status_cancel_and_invalidate(capsys, monkeypatch):
    """The port CLI's job commands print the daemon's replies."""
    import json

    d, c = start("torch", **RIG)
    port = ["--port", str(d.addr[1]), "--secret-env", "LOCUST_TEST_SECRET"]
    monkeypatch.setenv("LOCUST_TEST_SECRET", SECRET.decode())
    try:
        done = run_job(c, CORPUS_A, d)[0]["job_id"]
        d.scheduler.pause()
        queued = c.submit(corpus=CORPUS_B, config=CFG_OVR)["job_id"]
        capsys.readouterr()
        assert tserve_main.main(["status", done, *port]) == 0
        assert json.loads(capsys.readouterr().out)["state"] == "done"
        assert tserve_main.main(["cancel", queued, *port]) == 0
        assert json.loads(capsys.readouterr().out)["cancelled"] is True
        assert tserve_main.main(["invalidate", "--job-id", done, *port]) == 0
        assert "invalidated 1 cached result(s)" in capsys.readouterr().err
        assert tserve_main.main(["status", "nope", *port]) == 1
        assert "error: [unknown_job]" in capsys.readouterr().err
    finally:
        d.close()
