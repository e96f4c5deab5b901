"""PyTorch port, the distributor's data plane: the port's counterparts of
the framing, fetch and microbench tests of tests/test_dataplane.py.

Binary frames round-trip raw and zlib; every malformed frame (truncated
header, flipped bit, wrong MAC, version skew, corrupt or oversized zlib)
is a structured error, never a hang or silent corruption; the pipelined
windowed fetch is byte-exact and degrades to JSON against a JSON-only
worker; the default data plane moves at least 2x fewer wire bytes than
the JSON plane for the same loopback WordCount, whose reduced table is
the JAX one-shot CLI's bytes.
"""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import builtins
import hashlib
import os
import socket
import struct
import zlib

import numpy as np
import pytest
import torch

from locust_tpu import cli as jcli
from locust_tpu_torch import cli as tcli
from locust_tpu_torch.distributor import master, protocol
from locust_tpu_torch.distributor.microbench import VARIANTS, run_microbench
from locust_tpu_torch.distributor.worker import Worker
from locust_tpu_torch.io import serde

SECRET = b"dataplane-secret"


def _shutdown(w: Worker):
    try:
        master._rpc(w.addr, {"cmd": "shutdown"}, SECRET, timeout=5)
    except Exception:
        pass


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    return a, b


def _read_wire(sock) -> bytes:
    """One whole frame off ``sock``, length prefix included."""
    wire = bytearray()
    while len(wire) < 4:
        wire += sock.recv(4 - len(wire))
    (length,) = struct.unpack("!I", bytes(wire[:4]))
    while len(wire) < 4 + length:
        wire += sock.recv(4 + length - len(wire))
    return bytes(wire)


# ------------------------------------------------------------ binary framing


@pytest.mark.parametrize("compress", [False, True])
def test_bin_frame_roundtrip_raw_and_zlib(compress):
    meta = {"status": "ok", "offset": 7, "eof": False}
    payload = b"token\x00rows" * 4096  # compressible
    a, b = _pair()
    try:
        wire = protocol.send_bin_frame(a, meta, payload, SECRET, compress=compress)
        fr = protocol.recv_frame_ex(b, SECRET)
        assert fr.binary and fr.obj == meta and fr.payload == payload
        assert fr.compressed == compress and fr.wire_bytes == wire
        if compress:  # zlib actually shrank the wire
            assert wire < len(payload)
    finally:
        a.close()
        b.close()


def test_bin_frame_incompressible_payload_stays_raw():
    """The zlib flag is per frame: a payload that doesn't shrink ships raw."""
    payload = np.random.default_rng(5).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    a, b = _pair()
    try:
        protocol.send_bin_frame(a, {}, payload, SECRET, compress=True)
        fr = protocol.recv_frame_ex(b, SECRET)
        assert fr.payload == payload and not fr.compressed
    finally:
        a.close()
        b.close()


def test_bin_frame_wrong_mac_rejected():
    a, b = _pair()
    try:
        protocol.send_bin_frame(a, {"x": 1}, b"payload", SECRET)
        with pytest.raises(PermissionError):
            protocol.recv_frame_ex(b, b"not-the-secret")
    finally:
        a.close()
        b.close()


def test_bin_frame_bitflipped_payload_rejected():
    a, b = _pair()
    c, d = _pair()
    try:
        protocol.send_bin_frame(a, {"x": 1}, b"A" * 1024, SECRET)
        wire = bytearray(_read_wire(b))
        wire[-1] ^= 0x40  # flip a payload bit after the MAC was computed
        c.sendall(bytes(wire))
        with pytest.raises(PermissionError):
            protocol.recv_frame_ex(d, SECRET)
    finally:
        for s in (a, b, c, d):
            s.close()


def test_bin_frame_truncated_header_structured_error():
    c, d = _pair()
    try:
        body = protocol.BIN_MAGIC + b"\x01"  # 4 bytes, far short of the header
        c.sendall(struct.pack("!I", len(body)) + body)
        with pytest.raises(protocol.ProtocolError, match="shorter than"):
            protocol.recv_frame_ex(d, SECRET)
    finally:
        c.close()
        d.close()


def test_bin_frame_version_skew_structured_error():
    """A v2 frame against this v1 receiver: loud ProtocolError, no misparse."""
    meta = b"{}"
    body = b"data"
    mac = protocol._mac_raw(SECRET, bytes((2, 0, 0)) + meta + body)
    frame = protocol._BIN_HEADER.pack(protocol.BIN_MAGIC, 2, 0, 0, len(meta), mac) + meta + body
    c, d = _pair()
    try:
        c.sendall(struct.pack("!I", len(frame)) + frame)
        with pytest.raises(protocol.ProtocolError, match="version 2"):
            protocol.recv_frame_ex(d, SECRET)
    finally:
        c.close()
        d.close()


def test_bin_frame_corrupt_zlib_payload_structured_error():
    """A MAC-valid frame whose zlib stream is garbage (the io.chunk fault
    shape): a structured ProtocolError."""
    good = zlib.compress(b"payload" * 100, 1)
    bad = bytes([good[0] ^ 0xFF]) + good[1:]
    a, b = _pair()
    try:
        protocol.send_bin_frame_encoded(a, {"status": "ok"}, bad, SECRET,
                                        flags=protocol.FLAG_ZLIB)
        with pytest.raises(protocol.ProtocolError, match="zlib"):
            protocol.recv_frame_ex(b, SECRET)
    finally:
        a.close()
        b.close()


def test_frame_too_large_exact_boundary(monkeypatch):
    """A body of MAX_FRAME bytes passes, MAX_FRAME+1 raises FrameTooLarge
    carrying the numbers, on both sides and for both frame kinds."""
    monkeypatch.setattr(protocol, "MAX_FRAME", 4096)
    header = protocol._BIN_HEADER.size + 2  # meta == b"{}"
    a, b = _pair()
    c, d = _pair()
    try:
        fits = b"x" * (4096 - header)
        assert protocol.send_bin_frame_encoded(a, {}, fits, SECRET) == 4100
        assert protocol.recv_frame_ex(b, SECRET).payload == fits
        with pytest.raises(protocol.FrameTooLarge) as ei:
            protocol.send_bin_frame_encoded(a, {}, fits + b"y", SECRET)
        assert ei.value.size == 4097 and ei.value.limit == 4096
        assert isinstance(ei.value, ValueError)
        with pytest.raises(protocol.FrameTooLarge):
            protocol.send_frame(a, {"blob": "z" * 8192}, SECRET)
        c.sendall(struct.pack("!I", 4097))
        with pytest.raises(protocol.FrameTooLarge):
            protocol.recv_frame_ex(d, SECRET)
    finally:
        for s in (a, b, c, d):
            s.close()


def test_bin_frame_fuzz_mutations_never_silent():
    """Seeded fuzz: any single mutation of a valid binary frame raises a
    structured error; it never returns other bytes as if valid."""
    meta = {"status": "ok", "offset": 0}
    payload = b"fuzz-payload" * 300
    a, b = _pair()
    try:
        protocol.send_bin_frame(a, meta, payload, SECRET, compress=True)
        wire = _read_wire(b)
    finally:
        a.close()
        b.close()
    rng = np.random.default_rng(7)
    for trial in range(40):
        mutated = bytearray(wire)
        if trial % 4 == 0:  # truncate
            mutated = mutated[:int(rng.integers(4, len(wire)))]
        else:  # bit-flip anywhere, length prefix included
            mutated[int(rng.integers(0, len(wire)))] ^= int(rng.integers(1, 256))
        c, d = _pair()
        try:
            d.settimeout(2)
            c.sendall(bytes(mutated))
            c.close()
            try:
                fr = protocol.recv_frame_ex(d, SECRET)
            except (PermissionError, ValueError, ConnectionError, OSError):
                continue  # structured rejection: the contract
            assert fr.payload == payload and fr.obj == meta
        finally:
            c.close()
            d.close()


def test_zlib_bomb_rejected(monkeypatch):
    """Bounded decompression: a MAC-valid frame whose small zlib body
    expands past MAX_FRAME is rejected, not materialized."""
    monkeypatch.setattr(protocol, "MAX_FRAME", 1 << 20)
    bomb = zlib.compress(b"\x00" * (16 << 20), 9)
    assert len(bomb) < (1 << 20)
    a, b = _pair()
    try:
        protocol.send_bin_frame_encoded(a, {}, bomb, SECRET, flags=protocol.FLAG_ZLIB)
        with pytest.raises(protocol.ProtocolError, match="beyond MAX_FRAME"):
            protocol.recv_frame_ex(b, SECRET)
    finally:
        a.close()
        b.close()


# --------------------------------------------------------- pipelined fetch


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_fetch_chunk_clamped_to_worker_cap(tmp_path, monkeypatch):
    """A chunk size above the worker's FETCH_CHUNK_MAX clamp must not
    desync the pipelined offsets: the master clamps to the same cap."""
    monkeypatch.setattr(protocol, "FETCH_CHUNK_MAX", 64 * 1024)
    remote = str(tmp_path / "big.kvb")
    serde.write_kvbin([(b"key%06d" % i, i % 97) for i in range(20_000)], remote)
    w = Worker(secret=SECRET, workdir=str(tmp_path))
    w.serve_in_thread()
    try:
        local = str(tmp_path / "got")
        st = master.fetch_file(w.addr, remote, local, SECRET, expect_sha=_digest(remote),
                               window=4, chunk_bytes=8 << 20)
        assert _same_bytes(local, remote) and st["chunks"] > 1
    finally:
        _shutdown(w)


@pytest.fixture
def staged(tmp_path):
    """A multi-chunk packed-KV intermediate served by one loopback worker."""
    remote = str(tmp_path / "inter.kvb")
    serde.write_kvbin([(f"tok{i:07d}".encode(), i % 997 + 1) for i in range(80_000)], remote)
    w = Worker(secret=SECRET, workdir=str(tmp_path))
    w.serve_in_thread()
    yield w, remote, _digest(remote), tmp_path
    _shutdown(w)


def test_pipelined_fetch_multichunk_roundtrip(staged):
    w, remote, sha, tmp_path = staged
    local = str(tmp_path / "got")
    st = master.fetch_file(w.addr, remote, local, SECRET, expect_sha=sha,
                           window=4, chunk_bytes=128 * 1024)
    assert _same_bytes(local, remote)
    assert st["chunks"] > 4 and st["binary"] and st["zlib"]
    assert st["window"] == 4 and st["bytes"] == os.path.getsize(remote)
    assert 0 < st["wire_bytes"] < st["bytes"]  # compressed on the wire
    assert st["mb_s"] is not None and st["elapsed_s"] > 0


def test_fetch_interop_with_json_only_worker(tmp_path):
    """A pre-binary (JSON-only) worker and a binary-wanting master still
    complete the transfer, byte-identical."""
    remote = str(tmp_path / "x.kvb")
    serde.write_kvbin([(b"w%d" % i, i) for i in range(5000)], remote)
    w = Worker(secret=SECRET, workdir=str(tmp_path), support_binary=False)
    w.serve_in_thread()
    try:
        local = str(tmp_path / "got")
        st = master.fetch_file(w.addr, remote, local, SECRET, expect_sha=_digest(remote),
                               window=4, chunk_bytes=16 * 1024)
        assert _same_bytes(local, remote)
        assert st["binary"] is False and st["chunks"] > 1
    finally:
        _shutdown(w)


def test_worker_opens_one_handle_per_transfer(staged, monkeypatch):
    """The worker keeps ONE open handle per transfer, not one per chunk."""
    w, remote, sha, tmp_path = staged
    real_open = builtins.open
    opens = {"n": 0}

    def counting_open(path, *a, **kw):
        if str(path) == remote:
            opens["n"] += 1
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", counting_open)
    st = master.fetch_file(w.addr, remote, str(tmp_path / "got2"), SECRET, expect_sha=sha,
                           window=2, chunk_bytes=64 * 1024)
    monkeypatch.undo()
    assert st["chunks"] > 4
    assert opens["n"] == 1, f"worker opened the file {opens['n']} times"


def test_fetch_corrupt_chunk_raises_integrity(staged):
    """A worker-side payload corruption (io.chunk) surfaces as a structured
    master error, never silent bytes."""
    from locust_tpu_torch.utils import faultplan

    w, remote, sha, tmp_path = staged
    p = faultplan.FaultPlan([{"site": "io.chunk", "action": "corrupt", "times": 1}], seed=3)
    with faultplan.active_plan(p):
        with pytest.raises((master.MasterError, ValueError, OSError)):
            master.fetch_file(w.addr, remote, str(tmp_path / "got3"), SECRET,
                              expect_sha=sha, window=4, chunk_bytes=64 * 1024)
    assert p.rules[0].fired == 1


def test_fetch_end_to_end_digest_mismatch_raises(staged):
    """A digest recorded at map time that the assembled bytes do not
    match is an IntegrityError, on the binary and the JSON path."""
    w, remote, _, tmp_path = staged
    for use_binary in (True, False):
        with pytest.raises(master.IntegrityError, match="end-to-end"):
            master.fetch_file(w.addr, remote, str(tmp_path / "got4"), SECRET,
                              expect_sha="0" * 64, use_binary=use_binary,
                              chunk_bytes=256 * 1024)


# ------------------------------------------------- acceptance: wire bytes


def _wordy_corpus() -> list[bytes]:
    """A corpus whose post-combine intermediates are KBs, not bytes."""
    rng = np.random.default_rng(0)
    words = [b"w%05d" % i for i in range(4000)]
    return [b" ".join(words[j] for j in rng.integers(0, 4000, size=5)) for _ in range(3000)]


WORDY = ["--block-lines", "64", "--line-width", "64", "--emits-per-line", "8", "--no-timing"]


def _inproc_runner():
    def runner(req):
        args = [req["file"], str(req["line_start"]), str(req["line_end"]),
                str(req["node_num"]), "1", "-i", req["intermediate"], *WORDY,
                "--sort-mode", "hash", "--backend", "cpu"]
        if req.get("inter_format"):
            args += ["--inter-format", req["inter_format"]]
        rc = tcli.main(args)
        return {"status": "ok" if rc == 0 else "error", "returncode": rc,
                "log": "", "intermediate": req["intermediate"]}

    return runner


def test_wordcount_job_halves_wire_bytes_vs_json_plane(tmp_path, capsysbinary):
    """The default data plane (packed KV + binary frames + zlib) moves >= 2x
    fewer wire bytes than the JSON/base64 TSV plane for the same 2-worker
    loopback WordCount, and both reduced tables are the JAX one-shot
    CLI's bytes."""
    lines = _wordy_corpus()
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"\n".join(lines) + b"\n")

    def run(plane_kw, subdir):
        workers = [Worker(secret=SECRET, map_runner=_inproc_runner()) for _ in range(2)]
        for w in workers:
            w.serve_in_thread()
        # The two workers' maps run at once in this process and share its
        # intra-op thread pool: with torch's default thread count each op
        # of one map waits on the other's parallel regions, and on a
        # loaded host a map took 20x its time alone.  One thread each, as
        # two worker processes on their own cores would run.
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return master.run_job([w.addr for w in workers], str(corpus), SECRET,
                                  workdir=str(tmp_path / subdir), rpc_timeout=30.0,
                                  **plane_kw)
        finally:
            torch.set_num_threads(threads)
            for w in workers:
                _shutdown(w)

    new = run({}, "new")  # defaults: bin intermediates, binary+zlib wire
    old = run(dict(inter_format="tsv", use_binary=False, use_zlib=False), "old")
    dp_new, dp_old = new.dataplane(), old.dataplane()
    assert dp_new["binary"] and dp_new["zlib"] and not dp_old["binary"]
    assert all(serde.is_kvbin(p) for p in new)
    assert dp_old["wire_bytes"] >= 2 * dp_new["wire_bytes"], (dp_old, dp_new)

    def stdout(main, argv):
        capsysbinary.readouterr()
        assert main(argv) == 0
        return capsysbinary.readouterr().out

    want = stdout(jcli.main, [str(corpus), *WORDY, "--backend", "cpu"])
    for paths in (new, old):
        got = stdout(tcli.main, [str(corpus), "-1", "-1", "0", "2", *WORDY, "--backend", "cpu"]
                     + sum((["-i", t] for t in paths), []))
        assert got == want and got.count(b"\n") > 3000


# ----------------------------------------------------- microbench schema


def test_microbench_schema_pinned():
    res = run_microbench(target_bytes=256 * 1024, chunk_bytes=32 * 1024, window=4, repeats=1)
    assert set(res) == {"corpus_bytes", "chunk_bytes", "window", "repeats",
                        "variants", "summary"}
    assert set(res["variants"]) == set(VARIANTS)
    for name, st in res["variants"].items():
        assert {"bytes", "wire_bytes", "chunks", "binary", "zlib",
                "window", "elapsed_s", "mb_s"} <= set(st), name
        assert st["bytes"] == res["variants"]["json_w1"]["bytes"]
    s = res["summary"]
    assert set(s) == {"fetch_mb_s_json", "fetch_mb_s_bin", "pipeline_speedup",
                      "wire_bytes_json", "wire_bytes_bin_zlib",
                      "wire_reduction", "compression_ratio"}
    for v in s.values():
        assert isinstance(v, (int, float))
    assert s["wire_reduction"] > 1.0  # binary+zlib always beats base64 JSON
    assert res["variants"]["bin_wK_z"]["zlib"]
    assert not res["variants"]["json_w1"]["binary"]


def test_microbench_pipelined_binary_2x_json():
    """Pipelined binary fetch >= 2x the single-chunk JSON fetch throughput
    on loopback, best of three attempts (the bar is structural: no base64
    or JSON codec on the hot path)."""
    best = 0.0
    for _ in range(3):
        res = run_microbench(target_bytes=4 << 20, chunk_bytes=64 * 1024, window=4, repeats=2)
        best = max(best, res["summary"]["pipeline_speedup"])
        if best >= 2.0:
            break
    assert best >= 2.0, f"pipelined binary fetch only {best:.2f}x JSON"
