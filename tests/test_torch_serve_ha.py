"""PyTorch port, the serve tier's high availability against the JAX
package's: the fencing epoch and its file, the epoch guard, the ship
receiver's refusal of corrupt records, the standby's answers, promotion
by command and by lease replaying under the original job ids, async
shipping past a dead standby, a late standby's catch-up, the equal-epoch
tie break, the client's ``promote``, and the ``serve.ship`` fault site.
Each case runs a port pair on the CPU and, where the answers can be set
side by side, a JAX pair under the same calls."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import time

import pytest
from torch_serve_rig import (
    CFG_OVR,
    CORPUS_A,
    CORPUS_B,
    SECRET,
    abandon,
    ha_pair,
    key_tree,
    oracle,
    result_view,
    ship_converged,
    start,
    wait_replicated,
)

from locust_tpu.distributor import protocol as jprotocol
from locust_tpu.serve import ServeClient as JClient
from locust_tpu.serve import ServeConfig as JConfig
from locust_tpu.serve import ServeDaemon as JDaemon
from locust_tpu.serve import ServeError as JError
from locust_tpu.serve import replicate as jrep
from locust_tpu.serve.journal import JobJournal as JJournal
from locust_tpu.utils import faultplan as jfaults
from locust_tpu_torch.distributor import protocol as tprotocol
from locust_tpu_torch.serve import ServeClient as TClient
from locust_tpu_torch.serve import ServeConfig as TConfig
from locust_tpu_torch.serve import ServeDaemon as TDaemon
from locust_tpu_torch.serve import ServeError as TError
from locust_tpu_torch.serve import replicate as trep
from locust_tpu_torch.serve.journal import JobJournal as TJournal
from locust_tpu_torch.utils import faultplan as tfaults

CLIENTS = {"jax": JClient, "torch": TClient}
FAULTS = {"jax": jfaults, "torch": tfaults}


def test_ha_configs_require_a_journal_like_jax():
    for cfg in ({"ship_to": "127.0.0.1:1"}, {"standby_of": "127.0.0.1:1"}):
        with pytest.raises(ValueError, match="journal") as j:
            JDaemon(secret=SECRET, cfg=JConfig(**cfg))
        with pytest.raises(ValueError, match="journal") as t:
            TDaemon(secret=SECRET, cfg=TConfig(**cfg), device="cpu")
        assert str(t.value) == str(j.value)


def test_epoch_file_guard_and_stale_reply_equal_jax(tmp_path):
    """The epoch file is one format (each package reads the other's),
    the guard is monotone, and the fencing reply is the same dict."""
    for writer, reader in ((trep, jrep), (jrep, trep)):
        d = tmp_path / writer.__name__.split(".")[0]
        d.mkdir()
        assert reader.load_epoch(str(d)) == writer.load_epoch(str(d)) == 1
        writer.store_epoch(str(d), 5)
        assert reader.load_epoch(str(d)) == 5
        (d / trep.EPOCH_FILE).write_text("garbage")
        assert reader.load_epoch(str(d)) == writer.load_epoch(str(d)) == 1
    assert trep.EPOCH_FILE == jrep.EPOCH_FILE
    for protocol in (jprotocol, tprotocol):
        g = protocol.EpochGuard()
        assert [g.observe(1), g.observe(3), g.observe(2), g.observe(3)] == [None, None, 3, None]
        assert g.highest() == 3
    for args in ((4, None), (4, "h:1")):
        assert trep.stale_reply(*args) == jrep.stale_reply(*args)
    recs = [{"rec": "admit", "job_id": "a", "v": 1, "corpus_sha": ""}]
    assert trep.records_blob(recs) == jrep.records_blob(recs)
    assert trep.decode_blob(*trep.records_blob(recs)) == recs


def test_receiver_never_applies_corrupt_records_like_jax(tmp_path):
    """A blob whose checksum fails, and a sequence gap, are answered
    resync and nothing reaches the journal; the intact blob applies."""
    def go(journal_cls, rep, d):
        j = journal_cls(str(d))
        r = rep.ShipReceiver(j)
        text, checksum = rep.records_blob(
            [{"rec": "admit", "job_id": "a", "v": 1, "corpus_sha": ""}])
        replies = [r.handle_ship({"seq_from": 1, "records": text.replace("admit", "admxt"),
                                  "sum": checksum})]
        live = [[x["job_id"] for x in j.live_records()]]
        replies.append(r.handle_ship({"seq_from": 1, "records": text, "sum": checksum}))
        live.append([x["job_id"] for x in j.live_records()])
        text2, sum2 = rep.records_blob(
            [{"rec": "admit", "job_id": "b", "v": 1, "corpus_sha": ""}])
        replies.append(r.handle_ship({"seq_from": 5, "records": text2, "sum": sum2}))
        live.append([x["job_id"] for x in j.live_records()])
        j.close()
        return replies, live

    jv = go(JJournal, jrep, tmp_path / "j")
    tv = go(TJournal, trep, tmp_path / "t")
    assert tv == jv
    replies, live = tv
    assert replies[0]["resync"] is True and replies[0]["acked_seq"] == 0
    assert "resync" not in replies[1] and replies[1]["acked_seq"] == 1
    assert replies[2]["resync"] is True
    assert live == [[], ["a"], ["a"]]


def test_standby_refuses_the_job_plane_and_answers_stats_like_jax(tmp_path):
    def go(pkg):
        with ha_pair(tmp_path / pkg, pkg, pkg) as (primary, standby):
            sc = CLIENTS[pkg](standby.addr, SECRET, timeout=30.0)
            assert sc.ping() is True
            codes = [sc._rpc_one(standby.addr, {"cmd": cmd, "job_id": "x",
                                                "corpus_b64": "YQo="}).get("code")
                     for cmd in ("submit", "status", "result", "cancel", "invalidate")]
            want = f"{primary.addr[0]}:{primary.addr[1]}"
            deadline = time.monotonic() + 10.0
            while True:
                raw = sc._rpc_one(standby.addr, {"cmd": "submit", "corpus_b64": "YQo="})
                if raw.get("primary") == want or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            return (codes, raw.get("primary") == want, sc.stats()["replication"]["role"],
                    key_tree(sc.stats()["replication"]))

    assert go("torch") == go("jax")
    assert go("torch")[:3] == (["not_primary"] * 5, True, "standby")


def queued(client, job_id: str) -> bool:
    """Whether the daemon holds ``job_id`` in its queue (it may not know
    the job yet)."""
    try:
        return client.status(job_id)["state"] == "queued"
    except (JError, TError):
        return False


@pytest.mark.parametrize("how", ["command", "lease"])
def test_promotion_replays_under_the_original_ids(tmp_path, how):
    """Jobs acked on the primary and shipped, the primary killed without a
    graceful path; the standby promotes (by ``promote`` or by its lease),
    persists the bumped epoch, and answers each job under its original
    id as the JAX standby does."""
    def go(pkg):
        rep = {"jax": jrep, "torch": trep}[pkg]
        standby_kw = {"lease_s": 0.6} if how == "lease" else {}
        with ha_pair(tmp_path / pkg, pkg, pkg, standby_kw=standby_kw) as (primary, standby):
            primary.scheduler.pause()
            pc = CLIENTS[pkg](primary.addr, SECRET, timeout=30.0)
            ids = [pc.submit(corpus=c, config=CFG_OVR, no_cache=True)["job_id"]
                   for c in (CORPUS_A, CORPUS_B)]
            wait_replicated(standby, 2)
            # Both replayed jobs dispatch in one batch, as on the primary:
            # the standby holds dispatch until the replay queued them both.
            standby.scheduler.pause()
            abandon(primary)
            sc = CLIENTS[pkg](standby.addr, SECRET, timeout=30.0)
            if how == "command":
                res = sc.promote()
                assert res["role"] == "primary"
            deadline = time.monotonic() + 30.0
            while not all(queued(sc, j) for j in ids):
                assert time.monotonic() < deadline, "the promotion never replayed both jobs"
                time.sleep(0.02)
            standby.scheduler.resume()
            answers = [result_view(sc.wait(j, timeout=60.0)) for j in ids]
            statuses = [sc.status(j)["state"] for j in ids]
            epoch_file = rep.load_epoch(str(tmp_path / pkg / f"{pkg}-standby-journal"))
            return answers, statuses, standby.epoch, epoch_file

    j, t = go("jax"), go("torch")
    assert t == j
    answers, statuses, epoch, epoch_file = t
    assert [dict(a["pairs"]) for a in answers] == [oracle(CORPUS_A), oracle(CORPUS_B)]
    assert statuses == ["done", "done"] and epoch == epoch_file == 2


def test_dead_standby_never_fails_an_admit(tmp_path):
    def go(pkg):
        d, c = start(pkg, journal_dir=str(tmp_path / pkg), ship_to="127.0.0.1:1",
                     dispatch_poll_s=0.02)
        try:
            t0 = time.monotonic()
            ack = c.submit(corpus=CORPUS_A, config=CFG_OVR, no_cache=True)
            admit_s = time.monotonic() - t0
            res = c.wait(ack["job_id"], timeout=60.0)
            rep = c.stats()["replication"]
            return (result_view(res), admit_s < 5.0, rep["role"], rep["ship"]["connected"],
                    rep["ship"]["lag_records"] >= 1, key_tree(rep))
        finally:
            d.close()

    j, t = go("jax"), go("torch")
    assert t == j
    assert dict(t[0]["pairs"]) == oracle(CORPUS_A) and t[1:5] == (True, "primary", False, True)


def test_late_standby_catches_up_and_promotes_exactly(tmp_path):
    """A standby that starts serving after the primary has history
    converges through a snapshot catch-up and on-demand spill pulls;
    promoted, it answers the live job exactly."""
    standby = TDaemon(secret=SECRET, device="cpu", cfg=TConfig(
        journal_dir=str(tmp_path / "standby"), standby_of="127.0.0.1:9", dispatch_poll_s=0.02))
    primary = None
    try:
        primary, pc = start("torch", journal_dir=str(tmp_path / "primary"),
                            ship_to=f"{standby.addr[0]}:{standby.addr[1]}",
                            dispatch_poll_s=0.02, ship_heartbeat_s=0.2)
        pc.wait(pc.submit(corpus=CORPUS_B, config=CFG_OVR, no_cache=True)["job_id"],
                timeout=60.0)
        primary.scheduler.pause()
        live = pc.submit(corpus=CORPUS_A, config=CFG_OVR, no_cache=True)["job_id"]
        standby.serve_in_thread()
        deadline = time.monotonic() + 20.0
        while not (standby.receiver.stats()["catchups"] >= 1 and standby.journal.spill_exists(
                primary._jobs[live].corpus_digest)):
            assert time.monotonic() < deadline, standby.receiver.stats()
            time.sleep(0.02)
        abandon(primary)
        sc = TClient(standby.addr, SECRET, timeout=30.0)
        sc.promote()
        assert dict(sc.wait(live, timeout=60.0)["pairs"]) == oracle(CORPUS_A)
    finally:
        if primary is not None:
            primary.close()
        standby.close()


def test_equal_epoch_dual_primaries_break_the_tie(tmp_path):
    """Two port daemons that both believe they are primary at epoch 1:
    the address tie break demotes exactly one."""
    a, _ = start("torch", journal_dir=str(tmp_path / "a"), ship_to="127.0.0.1:9",
                 dispatch_poll_s=0.02, ship_heartbeat_s=0.2)
    try:
        b, _ = start("torch", journal_dir=str(tmp_path / "b"),
                     ship_to=f"{a.addr[0]}:{a.addr[1]}", dispatch_poll_s=0.02,
                     ship_heartbeat_s=0.2)
        try:
            deadline = time.monotonic() + 20.0
            while {a.role, b.role} != {"primary", "standby"}:
                assert time.monotonic() < deadline, (a.role, b.role)
                time.sleep(0.02)
        finally:
            b.close()
    finally:
        a.close()


def test_client_promote_like_jax(tmp_path):
    """``promote`` targets exactly the first roster address: a dead one
    raises and the live standby stays a standby; a primary answers the
    structured ``bad_spec`` refusal; a standby promotes once and refuses
    the second.  The JAX client does the same against the port's pair."""
    for client_cls, error in ((TClient, TError), (JClient, JError)):
        with ha_pair(tmp_path / client_cls.__module__.split(".")[0]) as (primary, standby):
            with pytest.raises(OSError):
                client_cls([("127.0.0.1", 1), standby.addr], SECRET, timeout=0.5).promote()
            assert standby.role == "standby"
            with pytest.raises(error) as e:
                client_cls(primary.addr, SECRET, timeout=30.0).promote()
            assert e.value.code == "bad_spec"
            sc = client_cls(standby.addr, SECRET, timeout=30.0)
            assert sc.promote()["role"] == "primary"
            with pytest.raises(error) as e:
                sc.promote()
            assert e.value.code == "bad_spec" and "already the primary" in str(e.value)


def test_stats_replication_and_journal_keys_equal_jax(tmp_path):
    def go(pkg):
        with ha_pair(tmp_path / pkg, pkg, pkg) as (primary, standby):
            pc = CLIENTS[pkg](primary.addr, SECRET, timeout=30.0)
            pc.wait(pc.submit(corpus=CORPUS_A, config=CFG_OVR, no_cache=True)["job_id"],
                    timeout=60.0)
            wait_replicated(standby, 1)
            ps = pc.stats()
            ss = CLIENTS[pkg](standby.addr, SECRET, timeout=30.0).stats()
            return (key_tree(ps["replication"]), key_tree(ps["journal"]),
                    key_tree(ss["replication"]), ps["replication"]["role"],
                    ss["replication"]["role"])

    assert go("torch") == go("jax")


@pytest.mark.parametrize("rule", [
    {"site": "serve.ship", "action": "drop", "match": {"cmd": "ship"}, "times": 1},
    {"site": "serve.ship", "action": "corrupt", "match": {"cmd": "ship"}, "times": 1},
    {"site": "serve.ship", "action": "drop", "match": {"cmd": "spill"}, "times": 1},
    {"site": "serve.ship", "action": "delay", "delay_s": 0.5, "match": {"cmd": "ship"},
     "times": 1},
], ids=["ship-drop", "ship-corrupt", "spill-drop", "ship-delay"])
def test_serve_ship_fault_site_converges_like_jax(tmp_path, rule):
    """``serve.ship``: a dropped or corrupted ship, or a dropped spill,
    converges (a corrupt record is never applied), a delay only lags;
    the standby ends holding the primary's live job and its spill, and
    admits stay fast, in both packages."""
    def go(pkg):
        fp = FAULTS[pkg]
        with ha_pair(tmp_path / pkg, pkg, pkg) as (primary, standby):
            primary.scheduler.pause()
            with fp.active_plan(fp.FaultPlan([rule], seed=2)) as plan:
                pc = CLIENTS[pkg](primary.addr, SECRET, timeout=30.0)
                t0 = time.monotonic()
                jid = pc.submit(corpus=CORPUS_A, config=CFG_OVR, no_cache=True)["job_id"]
                admit_fast = time.monotonic() - t0 < 0.5
                converged = ship_converged(primary, standby, 1)
                fired = [r.fired for r in plan.rules]
            live = standby.journal.live_records()
            return (admit_fast, converged, fired, [r["job_id"] == jid for r in live],
                    standby.journal.spill_exists(live[0]["corpus_sha"]) if live else None,
                    standby.receiver.stats()["resyncs_answered"] >= 1)

    j, t = go("jax"), go("torch")
    assert t == j
    assert t[:5] == (True, True, [1], [True], True)
