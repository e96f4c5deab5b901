"""PyTorch port, the distributor across packages: the wire is one protocol.

Frames sent by either package are accepted by the other (JSON and
binary, raw and zlib) and are the same bytes; a replayed frame is
refused by either package's guard; the JAX master drives the port's
workers and the port's master drives JAX workers, in both intermediate
formats, and each reduced stdout is the JAX one-shot CLI's bytes; the
two microbenches report the same keys.
"""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import contextlib
import os
import socket
import tempfile
import time

import pytest

from locust_tpu import cli as jcli
from locust_tpu.distributor import master as jmaster
from locust_tpu.distributor import protocol as jproto
from locust_tpu.distributor.microbench import run_microbench as jbench
from locust_tpu.distributor.worker import Worker as JWorker
from locust_tpu_torch.distributor import master as tmaster
from locust_tpu_torch.distributor import protocol as tproto
from locust_tpu_torch.distributor.microbench import run_microbench as tbench
from locust_tpu_torch.distributor.worker import Worker as TWorker
from test_torch_distributor import (
    CORPUS,
    SECRET,
    jax_oneshot,
    make_inproc_runner,
    reduce_bytes,
    shutdown,
)

PROTOCOLS = {"jax": jproto, "port": tproto}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


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


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    return a, b


def _wire(send) -> bytes:
    """The bytes ``send(sock)`` puts on the wire."""
    a, b = _pair()
    try:
        send(a)
        a.close()
        out = bytearray()
        while chunk := b.recv(1 << 16):
            out += chunk
        return bytes(out)
    finally:
        a.close()
        b.close()


def test_protocol_constants_equal():
    for name in ("MAX_FRAME", "TRACE_KEY", "FETCH_CHUNK", "FETCH_CHUNK_MAX", "COMMANDS",
                 "SHIP_COMMANDS", "EPOCH_KEY", "REPLAY_WINDOW_SECS", "BIN_MAGIC",
                 "BIN_VERSION", "FLAG_ZLIB"):
        assert getattr(tproto, name) == getattr(jproto, name), name
    assert tproto._BIN_HEADER.format == jproto._BIN_HEADER.format


@pytest.mark.parametrize("sender,receiver", DIRECTIONS)
def test_json_frames_both_ways_same_bytes(sender, receiver):
    """A request (fresh stamp) from one package is accepted by the other;
    an unstamped reply is the same wire bytes from either package."""
    snd, rcv = PROTOCOLS[sender], PROTOCOLS[receiver]
    obj = {"cmd": "map", "file": "f.txt", "line_start": 0, "line_end": 7, "node_num": 1,
           "extra_args": ["--sort-mode", "fused"], "unicode": "wörd"}
    a, b = _pair()
    try:
        snd.send_frame(a, obj, SECRET)
        fr = rcv.recv_frame_ex(b, SECRET)
        assert not fr.binary and fr.payload is None
        assert {k: v for k, v in fr.obj.items() if k not in ("_ts", "_nonce")} == obj
        rcv.ReplayGuard().check(fr.obj)  # a fresh stamp passes the receiver's guard
    finally:
        a.close()
        b.close()
    assert (_wire(lambda s: snd.send_frame(s, obj, SECRET, sign_fresh=False))
            == _wire(lambda s: rcv.send_frame(s, obj, SECRET, sign_fresh=False)))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("sender,receiver", DIRECTIONS)
def test_bin_frames_both_ways_same_bytes(sender, receiver, compress):
    snd, rcv = PROTOCOLS[sender], PROTOCOLS[receiver]
    meta = {"status": "ok", "offset": 3, "total": 99, "eof": False, "sha256": "ab" * 32}
    payload = b"key\x00\x01counts" * 2000
    a, b = _pair()
    try:
        wire = snd.send_bin_frame(a, meta, payload, SECRET, compress=compress)
        fr = rcv.recv_frame_ex(b, SECRET)
        assert fr.binary and fr.obj == meta and fr.payload == payload
        assert fr.compressed == compress and fr.wire_bytes == wire
    finally:
        a.close()
        b.close()
    assert (_wire(lambda s: snd.send_bin_frame(s, meta, payload, SECRET, compress=compress))
            == _wire(lambda s: rcv.send_bin_frame(s, meta, payload, SECRET, compress=compress)))


@pytest.mark.parametrize("sender,receiver", DIRECTIONS)
def test_bad_mac_refused_across_packages(sender, receiver):
    snd, rcv = PROTOCOLS[sender], PROTOCOLS[receiver]
    for send in (lambda s: snd.send_frame(s, {"cmd": "ping"}, SECRET),
                 lambda s: snd.send_bin_frame(s, {}, b"x" * 64, SECRET)):
        a, b = _pair()
        try:
            send(a)
            with pytest.raises(PermissionError):
                rcv.recv_frame_ex(b, b"another-secret")
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("sender,receiver", DIRECTIONS)
def test_replayed_frame_refused_by_either_worker(sender, receiver):
    """A recorded frame (fixed nonce) sent by one package's client is
    answered once by the other package's worker and dropped when
    replayed; a stale stamp is dropped too."""
    snd = PROTOCOLS[sender]
    w = (JWorker if receiver == "jax" else TWorker)(secret=SECRET)
    w.serve_in_thread()
    try:
        frozen = {"cmd": "ping", "_ts": time.time(), "_nonce": f"replay-{sender}"}
        with socket.create_connection(w.addr, timeout=5) as s:
            snd.send_frame(s, frozen, SECRET, sign_fresh=False)
            assert snd.recv_frame(s, SECRET)["pong"] is True
        stale = {"cmd": "ping", "_ts": time.time() - 9999, "_nonce": f"stale-{sender}"}
        for frame in (frozen, stale):
            with socket.create_connection(w.addr, timeout=5) as s:
                snd.send_frame(s, frame, SECRET, sign_fresh=False)
                s.settimeout(1.0)
                with pytest.raises((ConnectionError, socket.timeout, OSError)):
                    snd.recv_frame(s, SECRET)
    finally:
        shutdown(w)


def test_replay_guards_agree():
    for proto in (jproto, tproto):
        g = proto.ReplayGuard()
        req = {"_ts": time.time(), "_nonce": "n"}
        g.check(req)
        with pytest.raises(PermissionError, match="nonce reuse"):
            g.check(req)
        with pytest.raises(PermissionError, match="stale"):
            g.check({"_ts": time.time() - 500, "_nonce": "m"})
        with pytest.raises(PermissionError, match="missing"):
            g.check({"cmd": "ping"})


@pytest.fixture
def maps_written():
    """The intermediates a test's maps wrote outside ``tmp_path`` (the
    masters name them in the temporary directory, JAX's under /tmp);
    removed when the test ends."""
    paths = []
    yield paths
    for path in paths:
        with contextlib.suppress(FileNotFoundError):
            os.remove(path)


def remembering(runner, paths):
    """``runner``, noting each intermediate it is asked to write."""

    def run(req):
        paths.append(req["intermediate"])
        return runner(req)

    return run


@pytest.mark.parametrize("inter_format", ["tsv", "bin"])
def test_jax_master_over_port_workers(inter_format, corpus_file, tmp_path,
                                      capsysbinary, want, maps_written):
    """The JAX master fans out to port workers (which map with the port's
    CLI); the JAX stage-2 reduce of what it fetched is the JAX one-shot
    CLI's bytes.  The JAX master names its remote intermediates under
    /tmp, so the port workers' containment boundary is /tmp."""
    runner = remembering(make_inproc_runner(), maps_written)
    workers = [TWorker(secret=SECRET, map_runner=runner, workdir="/tmp") for _ in range(2)]
    for w in workers:
        w.serve_in_thread()
    try:
        res = jmaster.run_job([w.addr for w in workers], corpus_file, SECRET,
                              workdir=str(tmp_path / "m"), inter_format=inter_format)
        assert len(res) == 2 and res.dataplane()["binary"]
        assert reduce_bytes(corpus_file, res, capsysbinary, main=jcli.main) == want
        assert reduce_bytes(corpus_file, res, capsysbinary) == want
    finally:
        for w in workers:
            shutdown(w)


@pytest.mark.parametrize("inter_format", ["tsv", "bin"])
def test_port_master_over_jax_workers(inter_format, corpus_file, tmp_path,
                                      capsysbinary, want, maps_written):
    """The port's master fans out to JAX workers (which map with the JAX
    CLI); the port's stage-2 reduce of what it fetched is the JAX
    one-shot CLI's bytes."""
    runner = remembering(make_inproc_runner(main=jcli.main), maps_written)
    workers = [JWorker(secret=SECRET, map_runner=runner, workdir=tempfile.gettempdir())
               for _ in range(2)]
    for w in workers:
        w.serve_in_thread()
    try:
        res = tmaster.run_job([w.addr for w in workers], corpus_file, SECRET,
                              workdir=str(tmp_path / "m"), inter_format=inter_format)
        assert len(res) == 2 and res.dataplane()["binary"]
        assert reduce_bytes(corpus_file, res, capsysbinary) == want
    finally:
        for w in workers:
            shutdown(w)


def test_mixed_cluster_json_plane(corpus_file, tmp_path, capsysbinary, want, maps_written):
    """One JAX worker and one port worker behind the port's master on the
    pre-binary JSON plane: the job completes exactly."""
    workers = [JWorker(secret=SECRET,
                       map_runner=remembering(make_inproc_runner(main=jcli.main), maps_written),
                       workdir=tempfile.gettempdir()),
               TWorker(secret=SECRET,
                       map_runner=remembering(make_inproc_runner(), maps_written))]
    for w in workers:
        w.serve_in_thread()
    try:
        res = tmaster.run_job([w.addr for w in workers], corpus_file, SECRET,
                              workdir=str(tmp_path / "m"), use_binary=False)
        assert not res.dataplane()["binary"]
        assert reduce_bytes(corpus_file, res, capsysbinary) == want
    finally:
        for w in workers:
            shutdown(w)


def test_microbench_keys_equal_jax():
    kw = dict(target_bytes=64 * 1024, chunk_bytes=16 * 1024, window=4, repeats=1)
    j, t = jbench(**kw), tbench(**kw)

    def shape(d):
        return {k: shape(v) if isinstance(v, dict) else type(v).__name__ for k, v in d.items()}

    assert set(t) == set(j) and set(t["summary"]) == set(j["summary"])
    assert {n: set(v) for n, v in t["variants"].items()} == {
        n: set(v) for n, v in j["variants"].items()}
    # The staged intermediate and the wire are the same bytes in both.
    for name in j["variants"]:
        for key in ("bytes", "wire_bytes", "chunks", "binary", "zlib", "window"):
            assert t["variants"][name][key] == j["variants"][name][key], (name, key)
    assert shape(t["summary"]) == shape(j["summary"])
    assert t["corpus_bytes"] == j["corpus_bytes"]
