"""PyTorch port, the serve tier across packages: a JAX client drives a
port daemon and a port client a JAX daemon (the wire is the
distributor's protocol in both), and a journal or a warm directory
written by one package's daemon replays in the other's — every answer
exact against the oracle and the other package's."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import pytest
from torch_serve_rig import (
    CFG_OVR,
    CORPUS_A,
    CORPUS_B,
    SECRET,
    abandon,
    oracle,
    result_view,
    start,
)

from locust_tpu.serve import ServeClient as JClient
from locust_tpu.serve import ServeError as JError
from locust_tpu_torch.serve import ServeClient as TClient
from locust_tpu_torch.serve import ServeError as TError

OTHER = {"jax": "torch", "torch": "jax"}
CLIENTS = {"jax": JClient, "torch": TClient}
ERRORS = (JError, TError)
RIG = dict(max_queue=8, max_batch=4, dispatch_poll_s=0.02)


@pytest.mark.parametrize("daemon_pkg", ["torch", "jax"])
def test_client_of_one_package_drives_the_daemon_of_the_other(daemon_pkg):
    d, _ = start(daemon_pkg, **RIG)
    c = CLIENTS[OTHER[daemon_pkg]](d.addr, SECRET, timeout=60.0)
    try:
        assert c.ping()
        d.scheduler.pause()
        acks = [c.submit(corpus=x, config=CFG_OVR, tenant=t)
                for x, t in ((CORPUS_A, "a"), (CORPUS_B, "b"), (CORPUS_A + CORPUS_B, "a"))]
        assert c.cancel(acks[2]["job_id"])["cancelled"] is True
        d.scheduler.resume()
        for ack, x in zip(acks[:2], (CORPUS_A, CORPUS_B)):
            res = c.wait(ack["job_id"], timeout=60.0)
            assert dict(res["pairs"]) == oracle(x) and res["cache"] == "cold"
        with pytest.raises(ERRORS) as e:
            c.result(acks[2]["job_id"])
        assert e.value.code == "cancelled"
        again = c.submit(corpus=CORPUS_A, config=CFG_OVR)
        assert again["cached"] is True
        assert c.invalidate(job_id=again["job_id"]) == 1
        st = c.stats()
        assert st["completed"] == 3 and st["exec_cache"]["compiles"] == 1
        assert c.shutdown() is True
    finally:
        d.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_written_by_one_package_replays_in_the_other(writer, tmp_path):
    jdir = str(tmp_path / "journal")
    d, c = start(writer, journal_dir=jdir, **RIG)
    d.scheduler.pause()
    ids = [c.submit(corpus=x, config=CFG_OVR, no_cache=i == 1)["job_id"]
           for i, x in enumerate((CORPUS_A, CORPUS_B))]
    cancelled = c.submit(corpus=b"never run\n", config=CFG_OVR)["job_id"]
    c.cancel(cancelled)
    abandon(d)
    d2, c2 = start(OTHER[writer], journal_dir=jdir, **RIG)
    try:
        for jid, x in zip(ids, (CORPUS_A, CORPUS_B)):
            assert dict(c2.wait(jid, timeout=60.0)["pairs"]) == oracle(x)
        with pytest.raises(ERRORS) as e:
            c2.result(cancelled)
        assert e.value.code == "cancelled"
    finally:
        d2.close()
    assert (tmp_path / "journal" / "journal.jsonl").read_bytes() == b""


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_warm_dir_written_by_one_package_restores_in_the_other(writer, tmp_path):
    kw = dict(warm_dir=str(tmp_path / "warm"), warm_every=1, **RIG)
    lossy = b"a b c d e f g h i j k l m\n" * 4
    d, c = start(writer, **kw)
    try:
        first = [result_view(c.wait(c.submit(corpus=x, config=CFG_OVR)["job_id"],
                                    timeout=60.0)) for x in (CORPUS_A, lossy)]
    finally:
        d.close()
    d2, c2 = start(OTHER[writer], **kw)
    try:
        for x, want in zip((CORPUS_A, lossy), first):
            ack = c2.submit(corpus=x, config=CFG_OVR)
            assert ack["cached"] is True
            assert result_view(c2.result(ack["job_id"])) == dict(want, cache="result")
        assert c2.stats()["result_cache"]["entries"] == 2
    finally:
        d2.close()
