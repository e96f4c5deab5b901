"""PyTorch port, the serve tier's worker pool against the JAX package's:
placement, affinity and spill-over, shard ranges, the ``--serve``
worker's answers, a mixed-tenant stream sharded over two in-thread port
workers, affinity repeats, and the ``serve.place`` fault site.  Each case
runs the same calls through a JAX pool and a port pool (on the CPU) and
holds the answers equal, the pairs to the oracle and the one-shot CLI."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import time

import pytest
from torch_serve_rig import (
    CFG_OVR,
    SECRET,
    oracle,
    pool,
    roster,
    run_wait,
    start,
    start_workers,
    stop_workers,
    worker_index,
)

from locust_tpu import cli as jcli
from locust_tpu.distributor import worker as jworker
from locust_tpu.serve import pool as jpool
from locust_tpu.serve.cache import ExecutableCache as JCache
from locust_tpu.serve.jobs import JobSpec as JSpec
from locust_tpu.utils import faultplan as jfaults
from locust_tpu_torch import cli as tcli
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.distributor import worker as tworker
from locust_tpu_torch.serve import pool as tpool
from locust_tpu_torch.serve.cache import ExecutableCache as TCache
from locust_tpu_torch.serve.jobs import JobSpec as TSpec
from locust_tpu_torch.utils import faultplan as tfaults

PKGS = {"jax": (jpool, jfaults), "torch": (tpool, tfaults)}

STREAM = [(f"w{i} alpha beta\ngamma w{i} delta\n" * 4).encode() for i in range(8)]
BIG = b"".join(f"t{i % 29} common x{i % 7}\n".encode() for i in range(80))


@pytest.fixture(scope="module")
def pools():
    """A JAX daemon over 2 JAX serve workers and a port daemon over 2 port
    serve workers, shared by the module (jobs of 4 blocks or more shard
    over 2 workers)."""
    with pool("jax", shard_min_blocks=4, shard_max=2) as jp, \
            pool("torch", shard_min_blocks=4, shard_max=2) as tp:
        yield {"jax": jp, "torch": tp}


def test_pool_placement_affinity_spillover_units(tmp_path):
    def go(mod):
        p = mod.WorkerPool(("h1:1", "h2:2"), SECRET, spill_dir=str(tmp_path / "sp"))
        key = (("wordcount", "fp"), 1)
        seq = []
        w = p.place(key)
        seq.append(w.idx)
        p.mark_warm(w, key)
        p.release(w)
        w2 = p.place(key)  # affinity: the warm worker
        w3 = p.place(key)  # the affine worker saturated: spill-over
        seq += [w2.idx, w3.idx, p.place(key)]  # everyone saturated: None
        st = p.stats()
        p.release(w2)
        p.release(w3)
        seq.append(p.place(key, exclude={0}).idx)
        p.close(timeout=1.0)
        seq.append(p.place(key))  # a closed pool never places
        return seq, {k: st[k] for k in ("affinity_hits", "spill_overs", "local_fallbacks",
                                        "placements", "inflight", "warm_keys")}

    j, t = go(jpool), go(tpool)
    assert t == j
    assert t[0] == [0, 0, 1, None, 1, None]
    assert t[1]["affinity_hits"] == t[1]["spill_overs"] == t[1]["local_fallbacks"] == 1


@pytest.mark.parametrize("addr", ["no-port-here", "h:", ":1", "h:port", ""])
def test_pool_bad_addresses_refuse_like_jax(addr, tmp_path):
    for mod in (jpool, tpool):
        with pytest.raises(ValueError):
            mod.parse_worker_addr(addr)
        with pytest.raises(ValueError):
            mod.WorkerPool((), SECRET, spill_dir=str(tmp_path / "sp"))
        assert mod.parse_worker_addr("127.0.0.1:80") == ("127.0.0.1", 80)
        assert mod.parse_worker_addr(("h", 9)) == ("h", 9)


def test_shard_ranges_and_stable_shard_ids_equal_jax():
    for n_lines in (1, 7, 8, 9, 63, 64, 65, 257, 4097):
        for block in (1, 8, 128):
            for shards in (1, 2, 3, 4):
                rs = tpool.shard_ranges(n_lines, block, shards)
                assert rs == jpool.shard_ranges(n_lines, block, shards)
                assert rs[0][0] == 0 and rs[-1][1] == n_lines and len(rs) <= shards
                assert all(a % block == 0 and b > a for a, b in rs)
    for job, a, b in (("j", 0, 8), ("j", 8, 16), ("abc", 3, 99)):
        assert tpool.stable_shard_id(job, a, b) == jpool.stable_shard_id(job, a, b)
    assert tpool.stable_shard_id("j", 0, 8) != tpool.stable_shard_id("j", 8, 16)


def test_worker_without_serve_answers_like_jax():
    """A worker started without ``--serve`` answers the three serve
    commands with the JAX worker's structured error."""
    ws = [jworker.Worker(secret=SECRET), tworker.Worker(secret=SECRET)]
    try:
        for cmd in ("serve_stats", "serve_batch", "plan_stage"):
            answers = [w._handle({"cmd": cmd, "phase": "map"}) for w in ws]
            assert answers[0] == answers[1] and answers[1]["status"] == "error"
            assert "not enabled" in answers[1]["error"]
    finally:
        stop_workers(ws)


def test_pool_connection_redials_after_the_worker_idles_it_out():
    """A worker drops a connection idle past its ``conn_timeout``; the
    pool's next RPC finds it closed and redials instead of failing the
    dispatch (and quarantining a healthy worker)."""
    w = tworker.Worker(secret=SECRET, serve=True, device="cpu", conn_timeout=0.2)
    w.serve_in_thread()
    pw = tpool.PoolWorker(0, w.addr)
    try:
        first = pw.rpc({"cmd": "ping"}, SECRET, timeout=10.0)
        conn = pw._conn
        deadline = time.monotonic() + 10.0
        while not tpool._peer_closed(conn):
            assert time.monotonic() < deadline, "the worker never idled the connection out"
            time.sleep(0.05)
        assert pw.rpc({"cmd": "ping"}, SECRET, timeout=10.0) == first == {"status": "ok",
                                                                           "pong": True}
        assert pw._conn is not conn
    finally:
        pw.close()
        stop_workers([w])


def test_pool_mixed_tenant_stream_byte_identical(pools, tmp_path, capsysbinary):
    """8 jobs over 3 tenants, then a job that shards over both workers:
    the port pool's answers equal the JAX pool's, a port daemon over ONE
    worker's (where the big job cannot shard and folds locally), the
    oracle, and the one-shot CLIs."""

    def run(pkg, client, daemon):
        ids = [client.submit(corpus=c, config=CFG_OVR, tenant=f"t{i % 3}")["job_id"]
               for i, c in enumerate(STREAM)]
        out = []
        for j in ids:
            r = client.wait(j, timeout=120.0)
            out.append((r["pairs"], r["distinct"], r["truncated"], r["overflow_tokens"]))
        res, st = run_wait(client, BIG, tenant="big", weight=2.0)
        out.append((res["pairs"], res["distinct"], res["truncated"], res["overflow_tokens"]))
        return out, st

    answers = {pkg: run(pkg, c, d) for pkg, (d, _, c) in pools.items()}
    ws = start_workers("torch", 1)
    try:
        d1, c1 = start("torch", workers=roster(ws), max_queue=16, max_batch=4,
                       dispatch_poll_s=0.02, shard_min_blocks=4, shard_max=2)
        try:
            single, single_st = run("torch", c1, d1)
        finally:
            d1.close()
    finally:
        stop_workers(ws)
    assert answers["torch"][0] == answers["jax"][0] == single
    for (pairs, _, _, _), c in zip(single, STREAM + [BIG]):
        assert dict(pairs) == oracle(c)
    for pkg, (d, _, c) in pools.items():
        st = answers[pkg][1]
        assert st["shards"] == 2 and st["placed_on"] == "shard:" + ",".join(
            w.name for w in d.pool.workers), pkg
        assert sum(c.stats()["pool"]["placements"]) > 0
    assert single_st["placed_on"] == "local" and not single_st["shards"]
    path = tmp_path / "big.txt"
    path.write_bytes(BIG)
    widths = ["--block-lines", "8", "--line-width", "64", "--key-width", "16",
              "--emits-per-line", "8", "--no-timing"]
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--backend", "cpu"])):
        capsysbinary.readouterr()
        assert main([str(path), *widths, *extra]) == 0
        outs.append(capsysbinary.readouterr().out)
    table = b"".join(k + b"\t" + str(v).encode() + b"\n" for k, v in answers["torch"][0][-1][0])
    assert outs[0] == outs[1] == table


def test_pool_affinity_repeats_land_warm_compiles_flat(pools):
    """Sequential jobs of one shape land on the worker that holds it warm
    (``placed_on``, ``cache=warm``) and its ``compiles`` stay flat, in the
    same order on both packages."""
    from locust_tpu.distributor.master import rpc

    cfg = dict(CFG_OVR, emits_per_line=7)  # a key no earlier job warmed

    def go(daemon, ws, client):
        def compiles():
            return [rpc(("127.0.0.1", w.addr[1]), {"cmd": "serve_stats"}, SECRET,
                        timeout=10.0)["exec_cache"]["compiles"] for w in ws]

        hits0 = client.stats()["pool"]["affinity_hits"]
        seq = []
        for wave in ("one", "two"):
            if wave == "two":
                c1 = compiles()
            for i in range(3):
                c = (f"{wave}{i} aa bb\ncc dd e{i}\n" * 3).encode()
                res, st = run_wait(client, c, cfg)
                assert dict(res["pairs"]) == oracle(c, emits=7)
                seq.append((wave, worker_index(daemon, st["placed_on"]), res["cache"]))
        assert compiles() == c1
        return seq, client.stats()["pool"]["affinity_hits"] - hits0

    j, t = (go(*pools[p]) for p in ("jax", "torch"))
    assert t == j
    assert [s[1:] for s in t[0]] == [(0, "cold")] + [(0, "warm")] * 5
    assert t[1] == 5


def test_pool_spillover_when_the_affine_worker_is_saturated(pools):
    cfg = dict(CFG_OVR, emits_per_line=6)

    def go(daemon, ws, client):
        res, st = run_wait(client, b"warm aa bb\ncc dd ee\n" * 3, cfg)
        victim = next(w for w in daemon.pool.workers if w.name == st["placed_on"])
        spills = client.stats()["pool"]["spill_overs"]
        with daemon.pool._lock:
            daemon.pool._inflight[victim.idx] = daemon.pool.max_inflight
        try:
            c2 = b"spill ff gg\nhh ii jj\n" * 3
            ack = client.submit(corpus=c2, config=cfg)
            res = client.wait(ack["job_id"], timeout=120.0)
            st2 = client.status(ack["job_id"])
            assert dict(res["pairs"]) == oracle(c2, emits=6)
        finally:
            with daemon.pool._lock:
                daemon.pool._inflight[victim.idx] = 0
        return (worker_index(daemon, st["placed_on"]), worker_index(daemon, st2["placed_on"]),
                res["cache"], client.stats()["pool"]["spill_overs"] - spills)

    j, t = (go(*pools[p]) for p in ("jax", "torch"))
    assert t == j == (0, 1, "cold", 1)


def test_pool_seed_affinity_survives_a_daemon_restart():
    """A new daemon against a still-warm worker re-learns its affinity
    home from ``serve_stats`` at start, as the JAX daemon does."""
    spec_cls = {"jax": (JSpec, JCache), "torch": (TSpec, TCache)}
    corpus = b"seed aa bb\ncc dd ee\n" * 3

    def go(pkg):
        ws = start_workers(pkg, 1)
        try:
            d1, c1 = start(pkg, workers=roster(ws), dispatch_poll_s=0.02)
            try:
                run_wait(c1, corpus)
            finally:
                d1.close()
            d2, c2 = start(pkg, workers=roster(ws), dispatch_poll_s=0.02)
            try:
                spec, cache = spec_cls[pkg]
                key = (cache.engine_key(spec(tenant="x", workload="wordcount",
                                             cfg=EngineConfig(**CFG_OVR))), 1)
                preferred = d2.pool.preferred(key)
                res, _ = run_wait(c2, corpus + b"more ff\n")
                return (preferred == roster(ws), res["cache"],
                        d2.pool.stats()["affinity_hits"], dict(res["pairs"]))
            finally:
                d2.close()
        finally:
            stop_workers(ws)

    j, t = go("jax"), go("torch")
    assert t == j
    assert t[:3] == (True, "warm", 1)
    assert t[3] == oracle(corpus + b"more ff\n")


@pytest.mark.parametrize("action", ["error", "delay"])
def test_serve_place_fault_site_answers_like_jax(pools, action):
    """``serve.place``: an "error" rule fails one placement and the batch
    folds on the daemon's local engine, byte-identical; a "delay" rule
    only slows the placement."""
    corpus = f"place {action} aa\nbb cc {action}\n".encode() * 3

    def go(pkg):
        daemon, _, client = pools[pkg]
        _, fp = PKGS[pkg]
        before = client.stats()["pool"]["local_fallbacks"]
        rule = {"site": "serve.place", "action": action, "times": 1, "delay_s": 0.05}
        with fp.active_plan(fp.FaultPlan([rule], seed=3)) as plan:
            res, st = run_wait(client, corpus, no_cache=True)
            fired = [r.fired for r in plan.rules]
        return (dict(res["pairs"]), worker_index(daemon, st["placed_on"]), fired,
                client.stats()["pool"]["local_fallbacks"] - before)

    j, t = go("jax"), go("torch")
    assert t == j
    assert t[0] == oracle(corpus)
    assert t[1:] == (("local", [1], 1) if action == "error" else (0, [1], 0))


def test_pool_worker_death_mid_batch_retries_on_the_survivor():
    """A worker held inside ``serve_batch`` (``rpc.delay``) whose accept
    loop and connection are cut: the daemon quarantines it and the retry
    lands the exact answer on the survivor, as in JAX."""
    import time

    corpus = b"death aa bb\ncc dd ee\n" * 3

    def go(pkg):
        _, fp = PKGS[pkg]
        live = start_workers(pkg, 2)
        d, c = start(pkg, workers=roster(live), max_queue=8, max_batch=2,
                     dispatch_poll_s=0.02, retry_base_s=0.02)
        try:
            victim = d.pool.workers[0]
            rule = {"site": "rpc.delay", "action": "delay", "delay_s": 1.0,
                    "match": {"cmd": "serve_batch"}, "times": 1}
            with fp.active_plan(fp.FaultPlan([rule])):
                ack = c.submit(corpus=corpus, config=CFG_OVR, no_cache=True)
                deadline = time.monotonic() + 10.0
                while not victim._conn_lock.locked() and time.monotonic() < deadline:
                    time.sleep(0.01)
                assert victim._conn_lock.locked(), "the dispatch never reached the victim"
                stop_workers(live[:1])
                if victim._conn is not None:
                    victim._conn.close()
                res = c.wait(ack["job_id"], timeout=60.0)
            st = c.status(ack["job_id"])
            return (dict(res["pairs"]), st["state"], st["attempts"] >= 1,
                    st["placed_on"] != victim.name,
                    c.stats()["pool"]["dispatch_failures"] >= 1)
        finally:
            d.close()
            stop_workers(live[1:])

    j, t = go("jax"), go("torch")
    assert t == j
    assert t == (oracle(corpus), "done", True, True, True)
