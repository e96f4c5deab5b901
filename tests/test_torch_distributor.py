"""PyTorch port, the distributor: master + workers on 127.0.0.1.

The port's counterparts of tests/test_distributor.py, plus what only the
port has: the serve surface's device rule, the default map runner (the port's
stage-1 CLI in a subprocess) and the map that finds no GPU.  Workers run
with an in-process map runner that calls the port's CLI with ``--backend
cpu``; every reduced table is the bytes of the JAX one-shot CLI on the
same corpus.
"""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os
import socket
import struct
import sys
import threading
import time

import pytest

from locust_tpu import cli as jcli
from locust_tpu_torch import cli as tcli
from locust_tpu_torch.distributor import master, protocol
from locust_tpu_torch.distributor.worker import Worker

SECRET = b"test-secret"

CORPUS = b"""alpha beta gamma
beta gamma delta
gamma delta epsilon
delta epsilon alpha
epsilon alpha beta
"""

# The widths of tests/test_distributor.py, on the CPU.
WIDTHS = ["--block-lines", "8", "--line-width", "64", "--emits-per-line", "8"]
CPU_ARGS = WIDTHS + ["--no-timing", "--backend", "cpu"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_inproc_runner(main=tcli.main, extra=("--backend", "cpu")):
    """Map runner invoking a package's CLI in-process (the port's by
    default, on the CPU)."""

    def runner(req):
        args = [req["file"], str(req["line_start"]), str(req["line_end"]),
                str(req["node_num"]), "1", "-i", req["intermediate"],
                *WIDTHS, "--no-timing", *extra]
        if req.get("inter_format"):  # the master's negotiated data plane
            args += ["--inter-format", req["inter_format"]]
        rc = main(args)
        return {"status": "ok" if rc == 0 else "error", "returncode": rc,
                "log": "", "intermediate": req["intermediate"]}

    return runner


def shutdown(w, secret=SECRET, rpc=master._rpc):
    try:
        rpc(w.addr, {"cmd": "shutdown"}, secret, timeout=5)
    except Exception:
        pass


def reduce_bytes(corpus_file, paths, capsysbinary, main=tcli.main, extra=("--backend", "cpu")):
    """Stage-2 reduce over the collected intermediates; raw stdout bytes."""
    capsysbinary.readouterr()
    rc = main([corpus_file, "-1", "-1", "0", "2", *WIDTHS, "--no-timing", *extra]
              + sum((["-i", p] for p in paths), []))
    assert rc == 0
    return capsysbinary.readouterr().out


def jax_oneshot(corpus_file, capsysbinary) -> bytes:
    """The JAX one-shot CLI's stdout on ``corpus_file`` at the test widths."""
    capsysbinary.readouterr()
    assert jcli.main([corpus_file, *WIDTHS, "--no-timing", "--backend", "cpu"]) == 0
    out = capsysbinary.readouterr().out
    assert out.count(b"\n") > 3
    return out


@pytest.fixture
def corpus_file(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(CORPUS)
    return str(p)


@pytest.fixture(scope="module")
def jax_cache():
    return {}


@pytest.fixture
def want(corpus_file, capsysbinary, jax_cache):
    """The JAX one-shot CLI's bytes for CORPUS (computed once per module)."""
    if "want" not in jax_cache:
        jax_cache["want"] = jax_oneshot(corpus_file, capsysbinary)
    return jax_cache["want"]


def test_cluster_file_parser(tmp_path):
    p = tmp_path / "cluster.txt"
    p.write_text("# comment\n127.0.0.1 4001\n127.0.0.1 4002\n\n")
    assert protocol.parse_cluster_file(str(p)) == [
        ("127.0.0.1", 4001),
        ("127.0.0.1", 4002),
    ]
    bad = tmp_path / "bad.txt"
    bad.write_text("127.0.0.1\n")
    with pytest.raises(ValueError):
        protocol.parse_cluster_file(str(bad))
    empty = tmp_path / "empty.txt"
    empty.write_text("# nobody\n")
    with pytest.raises(ValueError, match="no nodes"):
        protocol.parse_cluster_file(str(empty))


def test_worker_requires_secret():
    with pytest.raises(ValueError):
        Worker(secret=b"")


def test_worker_refuses_serve_until_the_serve_slice(capsys, monkeypatch):
    """The serve surface: ``serve=True`` now constructs (on the CPU when
    asked) and answers ``serve_stats`` as the JAX worker does; ``--serve``
    with no card, or with a failed kernel build, exits 2 and never serves
    from the CPU; a worker without ``serve`` answers the serve commands
    with the JAX worker's structured error, never by accepting them."""
    import torch

    from locust_tpu.distributor.worker import Worker as JWorker
    from locust_tpu_torch import _build
    from locust_tpu_torch.distributor import worker as worker_mod

    served = [Worker(secret=SECRET, serve=True, device="cpu"), JWorker(secret=SECRET, serve=True)]
    try:
        stats = [w._handle({"cmd": "serve_stats"}) for w in served]
        assert stats[0] == stats[1]
        assert stats[0]["status"] == "ok" and stats[0]["warm_shapes"] == []
        assert served[0].device.type == "cpu"
    finally:
        for w in served:
            w._sock.close()
    monkeypatch.setenv("LOCUST_SECRET", "s")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert worker_mod.main(["--port", "0", "--serve"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err

    def failed_build(*a, **k):
        raise RuntimeError("nvcc failed: bitonic.cu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build", failed_build)
    assert worker_mod.main(["--port", "0", "--serve"]) == 2
    assert "nvcc failed" in capsys.readouterr().err
    w = Worker(secret=SECRET)
    w.serve_in_thread()
    try:
        for cmd in ("serve_batch", "serve_stats", "plan_stage"):
            resp = master._rpc(w.addr, {"cmd": cmd, "phase": "map"}, SECRET)
            assert resp == {"status": "error",
                            "error": "serve dispatch not enabled (start with --serve)"}
    finally:
        shutdown(w)


def test_worker_rejects_bad_mac():
    w = Worker(secret=SECRET)
    w.serve_in_thread()
    try:
        with socket.create_connection(w.addr, timeout=5) as s:
            protocol.send_frame(s, {"cmd": "ping"}, b"wrong-secret")
            s.settimeout(1.0)
            with pytest.raises((ConnectionError, socket.timeout, OSError)):
                protocol.recv_frame(s, b"wrong-secret")
    finally:
        shutdown(w)


def test_worker_ping_and_unknown_command():
    w = Worker(secret=SECRET)
    w.serve_in_thread()
    try:
        assert master._rpc(w.addr, {"cmd": "ping"}, SECRET)["pong"] is True
        resp = master._rpc(w.addr, {"cmd": "rm -rf /"}, SECRET)
        assert resp["status"] == "error"  # no arbitrary commands
    finally:
        shutdown(w)


def test_worker_survives_malformed_frames():
    """Garbage frames must not kill the daemon."""
    w = Worker(secret=SECRET)
    w.serve_in_thread()
    try:
        for garbage in [b"\x00\x00\x00\x03abc", b"\x00\x00\x00\x10[1]\nnot-json-at-all",
                        struct.pack("!I", 5) + protocol.BIN_MAGIC + b"\x01\x00"]:
            with socket.create_connection(w.addr, timeout=5) as s:
                s.sendall(garbage)
        assert master._rpc(w.addr, {"cmd": "ping"}, SECRET)["pong"] is True
    finally:
        shutdown(w)


def test_worker_accept_loop_survives_thread_spawn_failure(monkeypatch):
    """A connection thread that fails to SPAWN must not kill the accept
    loop, and must release its slot and close the orphaned socket:
    with max_connections=1 a leaked slot would wedge the next acquire."""
    import locust_tpu_torch.distributor.worker as worker_mod

    w = Worker(secret=SECRET, max_connections=1)
    w.serve_in_thread()
    real_thread = threading.Thread
    fails = {"left": 3}

    class FlakyThread(real_thread):
        def __init__(self, *args, target=None, **kwargs):
            if getattr(target, "__name__", "") == "_serve_one" and fails["left"] > 0:
                fails["left"] -= 1
                raise RuntimeError("injected spawn failure")
            super().__init__(*args, target=target, **kwargs)

    try:
        monkeypatch.setattr(worker_mod.threading, "Thread", FlakyThread)
        while fails["left"]:
            before = fails["left"]
            with pytest.raises(Exception):
                master._rpc(w.addr, {"cmd": "ping"}, SECRET, timeout=5)
            assert fails["left"] == before - 1
        monkeypatch.setattr(worker_mod.threading, "Thread", real_thread)
        assert master._rpc(w.addr, {"cmd": "ping"}, SECRET, timeout=5)["pong"] is True
    finally:
        monkeypatch.setattr(worker_mod.threading, "Thread", real_thread)
        shutdown(w)


def test_worker_fetch_path_containment(tmp_path):
    (tmp_path / "inside.tsv").write_bytes(b"a\t1\n")
    w = Worker(secret=SECRET, workdir=str(tmp_path))
    w.serve_in_thread()
    try:
        # The request cannot choose its own boundary: workdir is server-side.
        for path in ("/etc/passwd", str(tmp_path / ".." / "x"), str(tmp_path)):
            resp = master._rpc(w.addr, {"cmd": "fetch", "path": path, "workdir": "/"}, SECRET)
            assert resp["status"] == "error" and "outside" in resp["error"]
        resp = master._rpc(w.addr, {"cmd": "fetch", "path": str(tmp_path / "inside.tsv"),
                                    "offset": -1}, SECRET)
        assert resp == {"status": "error", "error": "negative offset"}
        resp = master._rpc(w.addr, {"cmd": "fetch", "path": str(tmp_path / "inside.tsv")},
                           SECRET)
        assert resp["status"] == "ok" and resp["eof"] and resp["total"] == 4
    finally:
        shutdown(w)


def test_worker_rejects_replayed_frame():
    """A recorded frame (same nonce) is dropped the second time, and a
    stale timestamp is dropped too."""
    w = Worker(secret=SECRET)
    w.serve_in_thread()
    try:
        frozen = {"cmd": "ping", "_ts": time.time(), "_nonce": "fixed-nonce-1"}
        with socket.create_connection(w.addr, timeout=5) as s:
            protocol.send_frame(s, frozen, SECRET, sign_fresh=False)
            assert protocol.recv_frame(s, SECRET)["pong"] is True
        stale = {"cmd": "ping", "_ts": time.time() - 9999, "_nonce": "n2"}
        for frame in (frozen, stale):
            with socket.create_connection(w.addr, timeout=5) as s:
                protocol.send_frame(s, frame, SECRET, sign_fresh=False)
                s.settimeout(1.0)
                with pytest.raises((ConnectionError, socket.timeout, OSError)):
                    protocol.recv_frame(s, SECRET)
    finally:
        shutdown(w)


@pytest.mark.parametrize("inter_format", ["bin", "tsv"])
def test_master_end_to_end_loopback(inter_format, corpus_file, tmp_path, capsysbinary, want):
    """Two workers, sharded map, fetch, local reduce: the reduced table is
    the JAX one-shot CLI's bytes."""
    runner = make_inproc_runner()
    w1 = Worker(secret=SECRET, map_runner=runner)
    w2 = Worker(secret=SECRET, map_runner=runner)
    w1.serve_in_thread()
    w2.serve_in_thread()
    try:
        res = master.run_job([w1.addr, w2.addr], corpus_file, SECRET,
                             workdir=str(tmp_path / "m"), inter_format=inter_format)
        assert len(res) == 2
        assert reduce_bytes(corpus_file, res, capsysbinary) == want
        dp = res.dataplane()
        assert dp["fetches"] == 2 and dp["binary"] and dp["payload_bytes"] > 0
    finally:
        shutdown(w1)
        shutdown(w2)


def test_master_reassigns_shard_of_dead_worker(corpus_file, tmp_path, capsysbinary, want):
    """A worker killed before its shard runs: the master reassigns the
    shard to a live worker and the job still yields the exact table."""
    runner = make_inproc_runner()
    w1 = Worker(secret=SECRET, map_runner=runner)
    w2 = Worker(secret=SECRET, map_runner=runner)
    w1.serve_in_thread()
    w2.serve_in_thread()
    shutdown(w2)  # kill node 1; its shard must fail over to node 0
    try:
        res = master.run_job([w1.addr, w2.addr], corpus_file, SECRET,
                             workdir=str(tmp_path / "m"))
        assert len(res) == 2 and {s.winner for s in res.shards} == {0}
        assert reduce_bytes(corpus_file, res, capsysbinary) == want
    finally:
        shutdown(w1)


def test_master_reassigns_on_map_failure(corpus_file, tmp_path, capsysbinary, want):
    """A worker whose map RUNS but fails (rc != 0) is quarantined and its
    shard is retried on a healthy node."""
    def bad(req):
        return {"status": "error", "returncode": 1, "log": "boom",
                "intermediate": req["intermediate"]}

    w1 = Worker(secret=SECRET, map_runner=make_inproc_runner())
    w2 = Worker(secret=SECRET, map_runner=bad)
    w1.serve_in_thread()
    w2.serve_in_thread()
    try:
        res = master.run_job([w1.addr, w2.addr], corpus_file, SECRET,
                             workdir=str(tmp_path / "m"))
        assert len(res) == 2
        assert reduce_bytes(corpus_file, res, capsysbinary) == want
    finally:
        shutdown(w1)
        shutdown(w2)


def test_master_raises_when_all_workers_dead(corpus_file, tmp_path):
    w1 = Worker(secret=SECRET, map_runner=make_inproc_runner())
    w1.serve_in_thread()
    shutdown(w1)
    with pytest.raises(master.MasterError, match="failed on every tried"):
        master.run_job([w1.addr], corpus_file, SECRET, workdir=str(tmp_path / "m"))


def test_chunked_fetch_roundtrips_beyond_frame_limit(tmp_path):
    """A >64MB intermediate streams in bounded chunks."""
    import base64

    import numpy as np

    big = tmp_path / "big.tsv"
    data = np.random.default_rng(0).integers(
        32, 127, size=protocol.MAX_FRAME + (1 << 20), dtype=np.uint8
    ).tobytes()
    big.write_bytes(data)
    w = Worker(secret=SECRET, workdir=str(tmp_path))
    w.serve_in_thread()
    try:
        local = tmp_path / "got.tsv"
        chunks = 0
        offset = 0
        with open(local, "wb") as f:
            while True:
                got = master._rpc(w.addr, {"cmd": "fetch", "path": str(big), "offset": offset},
                                  SECRET)
                assert got["status"] == "ok"
                blob = base64.b64decode(got["data_b64"])
                f.write(blob)
                offset += len(blob)
                chunks += 1
                if got["eof"]:
                    break
        assert chunks > 1  # actually exercised the windowing
        assert local.read_bytes() == data
    finally:
        shutdown(w)


def test_worker_serves_fetch_during_long_map(tmp_path):
    """Connections are served concurrently: a slow map must not block a
    ping or a fetch."""
    release = threading.Event()

    def slow_map(req):
        release.wait(timeout=30)
        return {"status": "ok", "returncode": 0, "log": "",
                "intermediate": req["intermediate"]}

    f = tmp_path / "x.tsv"
    f.write_bytes(b"word\t1\n")
    w = Worker(secret=SECRET, map_runner=slow_map, workdir=str(tmp_path))
    w.serve_in_thread()
    try:
        map_resp = {}

        def do_map():
            map_resp["r"] = master._rpc(
                w.addr, {"cmd": "map", "file": "f", "intermediate": "i"}, SECRET, timeout=60)

        t = threading.Thread(target=do_map, daemon=True)
        t.start()
        time.sleep(0.3)  # let the map start and block
        t0 = time.monotonic()
        got = master._rpc(w.addr, {"cmd": "fetch", "path": str(f)}, SECRET, timeout=10)
        assert got["status"] == "ok"
        assert time.monotonic() - t0 < 5  # did NOT wait for the map
        assert master._rpc(w.addr, {"cmd": "ping"}, SECRET, timeout=10)["pong"] is True
        release.set()
        t.join(timeout=30)
        assert not t.is_alive() and map_resp["r"]["status"] == "ok"
    finally:
        release.set()
        shutdown(w)


def test_master_cli_with_default_map_runner(corpus_file, tmp_path, capsysbinary, want,
                                             monkeypatch):
    """The user's path: two workers with the default runner (the port's
    stage-1 CLI in a subprocess each), ``master.main`` over a cluster
    file with ``--backend cpu`` in the passthrough, and ``--trace-out``
    merging both workers' ``worker.map`` spans under one trace id.  The
    stdout is the JAX one-shot CLI's bytes."""
    import json

    workers = [Worker(secret=SECRET, workdir=str(tmp_path)) for _ in range(2)]
    for w in workers:
        w.serve_in_thread()
    cluster = tmp_path / "cluster.txt"
    cluster.write_text("".join(f"{h} {p}\n" for h, p in (w.addr for w in workers)))
    trace = tmp_path / "job.trace.json"
    monkeypatch.setenv("LOCUST_SECRET", SECRET.decode())
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the map processes share the host's cores
    monkeypatch.setattr(master.tempfile, "gettempdir", lambda: str(tmp_path))
    try:
        capsysbinary.readouterr()
        rc = master.main([str(cluster), corpus_file, "--workdir", str(tmp_path / "m"),
                          "--trace-out", str(trace), *CPU_ARGS])
        got = capsysbinary.readouterr()
        assert rc == 0, got.err
        assert got.out == want
        assert b"[master] shard 1:" in got.err and b"dataplane:" in got.err
    finally:
        for w in workers:
            shutdown(w)
    doc = json.loads(trace.read_text())
    names = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    maps = [e for e in doc["traceEvents"] if e["name"] == "worker.map"]
    assert sorted(names[e["pid"]] for e in maps) == sorted(
        f"worker {h}:{p}" for h, p in (w.addr for w in workers))
    assert {e["name"] for e in doc["traceEvents"]} >= {"job.run", "master.map_rpc",
                                                       "master.fetch", "cli.run"}
    assert isinstance(doc["otherData"]["trace_id"], str)


def test_map_that_finds_no_gpu_fails_loud(corpus_file, tmp_path):
    """No hidden CPU: the default runner's subprocess runs the CLI on CUDA
    (no ``--backend cpu`` in the passthrough); with no GPU it exits
    non-zero, the worker replies an error, and the job raises."""
    w = Worker(secret=SECRET, workdir=str(tmp_path))
    w.serve_in_thread()
    try:
        resp = master._rpc(w.addr, {
            "cmd": "map", "file": corpus_file, "line_start": 0, "line_end": 5, "node_num": 0,
            "intermediate": str(tmp_path / "x.kvb"), "inter_format": "bin",
            "extra_args": WIDTHS + ["--no-timing"],
        }, SECRET, timeout=120)
        assert resp["status"] == "error" and resp["returncode"] == 1
        assert "CUDA is not available" in resp["log"]
        assert not os.path.exists(tmp_path / "x.kvb")
        with pytest.raises(master.MasterError, match="CUDA is not available"):
            master.run_job([w.addr], corpus_file, SECRET, workdir=str(tmp_path / "m"),
                           extra_args=WIDTHS, max_retries=0)
    finally:
        shutdown(w)


def test_job_timeline_merges_worker_spans(corpus_file, tmp_path):
    """With telemetry on, ``JobResult.timeline()`` is one Chrome trace under
    the master's trace id: its job and map-RPC spans and each worker's
    shipped ``worker.map`` span, filed under that worker's process."""
    from locust_tpu_torch import obs

    workers = [Worker(secret=SECRET, map_runner=make_inproc_runner()) for _ in range(2)]
    for w in workers:
        w.serve_in_thread()
    tracer = obs.enable(process="master")
    try:
        res = master.run_job([w.addr for w in workers], corpus_file, SECRET,
                             workdir=str(tmp_path / "m"))
        doc = res.timeline()
    finally:
        obs.disable()
        for w in workers:
            shutdown(w)
    assert doc["otherData"]["trace_id"] == tracer.trace_id
    names = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    maps = [e for e in doc["traceEvents"] if e["name"] == "worker.map"]
    assert sorted((names[e["pid"]], e["args"]["shard"]) for e in maps) == sorted(
        (f"worker {h}:{p}", i) for i, (h, p) in enumerate(w.addr for w in workers))
    rpcs = [e for e in doc["traceEvents"] if e["name"] == "master.map_rpc"]
    assert sorted(e["args"]["shard"] for e in rpcs) == [0, 1]
    assert all(names[e["pid"]] == "master" for e in rpcs)
    assert len([e for e in doc["traceEvents"] if e["name"] == "job.run"]) == 1


def test_default_map_runner_command(monkeypatch, tmp_path):
    """The runner's command line is the port's staged CLI contract, with
    the package's parent directory on PYTHONPATH."""
    from locust_tpu_torch.distributor import worker as worker_mod

    seen = {}

    class Proc:
        returncode = 0
        stderr = b"log"

    def fake_run(cmd, capture_output, env, timeout):
        seen.update(cmd=cmd, env=env, timeout=timeout)
        return Proc()

    monkeypatch.setattr(worker_mod.subprocess, "run", fake_run)
    resp = worker_mod.default_map_runner({
        "file": "f.txt", "line_start": 3, "line_end": 9, "node_num": 1,
        "intermediate": str(tmp_path / "o.kvb"), "inter_format": "bin",
        "extra_args": ["--sort-mode", "fused"]})
    assert seen["cmd"] == [sys.executable, "-m", "locust_tpu_torch", "f.txt", "3", "9", "1",
                           "1", "-i", str(tmp_path / "o.kvb"), "--inter-format", "bin",
                           "--sort-mode", "fused"]
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert seen["timeout"] == 1800
    assert resp == {"status": "ok", "returncode": 0, "log": "log",
                    "intermediate": str(tmp_path / "o.kvb")}


def test_default_map_runner_follows_map_command(monkeypatch, tmp_path):
    """``MAP_COMMAND`` is the whole prefix of a map's command line: a
    wrapper set there runs every map (chip_smoke.py counts the maps'
    kernel launches so)."""
    from locust_tpu_torch.distributor import worker as worker_mod

    seen = {}

    class Proc:
        returncode = 1
        stderr = b"no GPU"

    def fake_run(cmd, capture_output, env, timeout):
        seen["cmd"] = cmd
        return Proc()

    monkeypatch.setattr(worker_mod.subprocess, "run", fake_run)
    monkeypatch.setattr(worker_mod, "MAP_COMMAND", ("py", "wrap.py", "--child"))
    resp = worker_mod.default_map_runner({"file": "f.txt", "intermediate": "o.tsv"})
    assert seen["cmd"] == ["py", "wrap.py", "--child", "f.txt", "-1", "-1", "0", "1",
                           "-i", "o.tsv"]
    assert resp["status"] == "error" and resp["returncode"] == 1
