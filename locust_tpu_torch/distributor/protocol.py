"""Wire protocol for the distributor control plane and data plane.

Port of ``locust_tpu/distributor/protocol.py``, wire-identical: a frame
that either package sends, the other accepts (JSON and binary, raw and
zlib), so a cluster may mix the packages' masters and workers.  The
reference's protocol sent a whitespace-separated string that the slave
ran as a local command and answered "ACK" (reference
Distributor/slave.py:16-32).  Replaced with:

  * length-prefixed JSON frames (no recv(1024) truncation),
  * HMAC-SHA256 request authentication over a shared secret, with a
    timestamp and nonce under the MAC of every request (``ReplayGuard``),
  * a closed command whitelist (no shell),
  * structured replies carrying the subprocess exit status.

Two frame types share the 4-byte length prefix:

  * JSON frames, the control plane: every request and every small reply.
    The MAC covers ``json.dumps(obj, sort_keys=True)``; the frame is
    ``{"mac": ...}`` + ``\n`` + that payload.
  * BINARY frames (v1), the data plane: bulk fetch replies as header +
    raw-digest MAC + small JSON meta + RAW payload bytes, optionally one
    zlib stream (level 1) per frame.  A receiver tells them apart by the
    first body byte: binary frames start with NUL, which no JSON
    document can.

Negotiated per connection: a requester that wants binary replies says
so in its (JSON) request; a peer that does not understand ignores the
unknown keys and answers JSON.  The ``rpc.frame`` fault site
(utils/faultplan.py) mangles the framed wire bytes past the length
prefix.  Standard library only, besides the port's obs and faultplan.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import json
import os
import socket
import struct
import time
import zlib

from locust_tpu_torch import obs
from locust_tpu_torch.utils import faultplan

MAX_FRAME = 64 * 1024 * 1024  # hard frame bound; fetch stays far below it

# Cross-node trace correlation: requests carry an
# optional {"id": trace_id, "shard": n} dict under this key, workers run
# the command under a request-scoped tracer with that id and ship their
# span list back in the reply ("spans" + "clock"); binary fetch replies
# echo the id in the frame meta as "trace_id".  Peers that predate the
# key simply ignore it — same negotiation stance as the binary plane.
TRACE_KEY = "trace"


def trace_stamp(shard: int | None = None) -> dict | None:
    """The correlation stamp for an outgoing request: the active
    tracer's trace_id (+ the shard id for map requests), or None when
    telemetry is disabled (the request then carries no trace key at
    all — zero wire cost on the default path)."""
    t = obs.current()
    if t is None:
        return None
    stamp = {"id": t.trace_id}
    if shard is not None:
        stamp["shard"] = shard
    return stamp

# fetch window sizing: intermediates larger than one frame stream in
# offset-addressed chunks.  Raw bytes per chunk; base64 expands 4/3, so
# even the max chunk is well under MAX_FRAME.
FETCH_CHUNK = 8 * 1024 * 1024
FETCH_CHUNK_MAX = 32 * 1024 * 1024

# The closed command set, the JAX package's: serve_batch and serve_stats
# are the serve tier's scale-out dispatch surface and plan_stage the
# distributed-plan stage surface (serve/pool.py -> worker.py, one map
# split fold, shuffle-partition reduce, join bin or PageRank epoch shard
# per plan_stage RPC, epoch-fenced like serve_batch).  A worker started
# without --serve answers the three with a structured error, which the
# daemon reads as a failed placement its local engine absorbs.
COMMANDS = ("ping", "map", "fetch", "serve_batch", "serve_stats",
            "plan_stage", "shutdown")

# High-availability control plane (serve/replicate.py): the primary serve
# daemon ships its fsync'd WAL records to a hot standby over this same
# frame protocol.  ship = a sequence-numbered batch of journal records
# (a heartbeat when empty); ship_catchup = a full live-journal snapshot
# for a standby that connected late or fell behind; ship_spill = one
# content-addressed corpus spill, pulled on demand by sha reference.
SHIP_COMMANDS = ("ship", "ship_catchup", "ship_spill")

# Fencing epoch: every shipped record and every pool-worker RPC carries
# the sender's promotion epoch under this key.  Receivers track the
# highest epoch seen (EpochGuard) and reject lower ones with a
# structured ``stale_epoch``.
EPOCH_KEY = "_epoch"


class EpochGuard:
    """Monotone fencing-epoch tracker (one per receiving process).

    Thread-safe: serve_batch handlers and ship appliers run on
    concurrent connection threads, so the high-water mark mutates
    under a lock.
    """

    def __init__(self):
        import threading

        self._highest = 0
        self._lock = threading.Lock()

    def observe(self, epoch) -> int | None:
        """Record ``epoch``; returns None when it is current (>= the
        highest seen, which it then becomes), else the higher epoch
        already observed — the caller answers a structured
        ``stale_epoch`` naming it, never silently obeys a fenced-out
        sender."""
        e = int(epoch)
        with self._lock:
            if e < self._highest:
                return self._highest
            self._highest = e
            return None

    def highest(self) -> int:
        with self._lock:
            return self._highest

# Replay window: frames older than this are rejected; nonces are remembered
# for at least this long (worker side).
REPLAY_WINDOW_SECS = 120.0

# ---------------------------------------------------------- binary framing
# Body layout (after the shared 4-byte length prefix):
#   0   3  BIN_MAGIC  b"\x00LB"  (NUL first: cannot begin a JSON document)
#   3   1  version    (known: 1; anything else -> ProtocolError)
#   4   1  flags      (bit 0: payload is zlib-compressed)
#   5   1  reserved   (0)
#   6   2  meta_len   (!H)
#   8  32  mac        raw HMAC-SHA256 over version..reserved + meta + payload
#  40   m  meta       JSON dict (status/offset/total/eof/sha256/...)
#  40+m    payload    raw bytes (zlib stream if FLAG_ZLIB)
BIN_MAGIC = b"\x00LB"
BIN_VERSION = 1
FLAG_ZLIB = 0x01
_BIN_HEADER = struct.Struct("!3sBBBH32s")


class ProtocolError(ValueError):
    """Malformed/unsupported frame content (not an auth failure)."""


class FrameTooLarge(ProtocolError):
    """A frame body exceeding MAX_FRAME.  Structured: carries the exact
    size and limit so callers can chunk instead of parsing a message."""

    def __init__(self, size: int, limit: int = 0):
        self.size = int(size)
        self.limit = int(limit or MAX_FRAME)
        super().__init__(
            f"frame body of {self.size} bytes exceeds MAX_FRAME="
            f"{self.limit} by {self.size - self.limit}; chunk the transfer"
        )


def _mac(secret: bytes, payload: bytes) -> str:
    return hmac.new(secret, payload, hashlib.sha256).hexdigest()


def _mac_raw(secret: bytes, payload: bytes) -> bytes:
    return hmac.new(secret, payload, hashlib.sha256).digest()


def send_frame(
    sock: socket.socket, obj: dict, secret: bytes, sign_fresh: bool = True
) -> None:
    """Send one authenticated frame.

    ``sign_fresh`` stamps a timestamp + random nonce under the MAC so a
    recorded frame cannot be replayed later (requests); replies ride the
    same connection and skip the stamp.
    """
    if sign_fresh:
        obj = dict(obj, _ts=time.time(), _nonce=os.urandom(12).hex())
    payload = json.dumps(obj, sort_keys=True).encode()
    frame = json.dumps({"mac": _mac(secret, payload)}).encode() + b"\n" + payload
    if len(frame) > MAX_FRAME:
        raise FrameTooLarge(len(frame))
    wire = struct.pack("!I", len(frame)) + frame
    # Chaos: wire corruption/truncation (no-op without an active plan).
    # The 4-byte length header is preserved — a corrupted frame BODY is
    # caught by the HMAC (rejected, connection dropped) and a truncated
    # one by the receiver's bounded read timeout; both are the failure
    # modes the retry path must absorb (tests/test_faults.py).
    wire = faultplan.mangle(
        "rpc.frame", wire, keep_prefix=4, cmd=obj.get("cmd")
    )
    sock.sendall(wire)


def send_bin_frame(
    sock: socket.socket,
    meta: dict,
    payload: bytes,
    secret: bytes,
    compress: bool = False,
) -> int:
    """Send one authenticated BINARY frame (data plane).

    ``payload`` goes on the wire raw — no base64 — optionally through one
    per-frame zlib stream (``compress``; skipped when it doesn't shrink,
    which the receiver sees via the flags bit, not a meta field).  Binary
    frames are replies riding an already-authenticated request's
    connection, so like JSON replies they carry no freshness stamp; the
    MAC still covers header+meta+payload.  Returns bytes on the wire
    (length prefix included) so callers can account traffic exactly.
    """
    flags = 0
    body = payload
    if compress and payload:
        packed = zlib.compress(payload, 1)
        if len(packed) < len(payload):
            body, flags = packed, FLAG_ZLIB
    return send_bin_frame_encoded(sock, meta, body, secret, flags)


def send_bin_frame_encoded(
    sock: socket.socket,
    meta: dict,
    body: bytes,
    secret: bytes,
    flags: int = 0,
) -> int:
    """Low-level binary send: ``body`` goes on the wire as-is, ``flags``
    declares its encoding.  Split out so the worker can compress (and the
    chaos harness can mangle the ENCODED payload, io.chunk) before the
    frame is MAC'd — the MAC always covers the wire bytes."""
    meta_b = json.dumps(meta, sort_keys=True).encode()
    if len(meta_b) > 0xFFFF:
        raise ProtocolError(f"binary frame meta of {len(meta_b)} bytes > 64KiB")
    signed = bytes((BIN_VERSION, flags, 0)) + meta_b + body
    mac = _mac_raw(secret, signed)
    frame = (
        _BIN_HEADER.pack(BIN_MAGIC, BIN_VERSION, flags, 0, len(meta_b), mac)
        + meta_b
        + body
    )
    if len(frame) > MAX_FRAME:
        raise FrameTooLarge(len(frame))
    wire = struct.pack("!I", len(frame)) + frame
    wire = faultplan.mangle(
        "rpc.frame", wire, keep_prefix=4, cmd=meta.get("cmd", "fetch-data")
    )
    sock.sendall(wire)
    return len(wire)


@dataclasses.dataclass
class FrameIn:
    """One received frame, either kind, plus wire accounting.

    ``obj`` is the JSON document (JSON frame) or the meta dict (binary
    frame); ``payload`` is the decompressed raw payload (binary frames
    only, None for JSON); ``wire_bytes`` counts the length prefix too.
    """

    obj: dict
    payload: bytes | None
    wire_bytes: int
    binary: bool
    compressed: bool


def recv_frame_ex(sock: socket.socket, secret: bytes) -> FrameIn:
    header = _recv_exact(sock, 4)
    (length,) = struct.unpack("!I", header)
    if length > MAX_FRAME:
        raise FrameTooLarge(length)
    frame = _recv_exact(sock, length)
    if frame[:1] == b"\x00":
        return _parse_bin_frame(frame, secret, wire_bytes=length + 4)
    mac_line, _, payload = frame.partition(b"\n")
    try:
        mac = json.loads(mac_line)["mac"]
    except (ValueError, TypeError, KeyError):
        raise PermissionError("malformed auth header — rejecting frame")
    if not isinstance(mac, str) or not hmac.compare_digest(
        mac, _mac(secret, payload)
    ):
        raise PermissionError("bad HMAC — rejecting frame")
    return FrameIn(
        obj=json.loads(payload),
        payload=None,
        wire_bytes=length + 4,
        binary=False,
        compressed=False,
    )


def recv_frame(sock: socket.socket, secret: bytes) -> dict:
    """JSON-view receive (control plane): the frame's dict, either kind."""
    return recv_frame_ex(sock, secret).obj


def _parse_bin_frame(frame: bytes, secret: bytes, wire_bytes: int) -> FrameIn:
    if len(frame) < _BIN_HEADER.size:
        raise ProtocolError(
            f"binary frame of {len(frame)} bytes shorter than the "
            f"{_BIN_HEADER.size}-byte header"
        )
    magic, version, flags, reserved, meta_len, mac = _BIN_HEADER.unpack(
        frame[: _BIN_HEADER.size]
    )
    if magic != BIN_MAGIC:
        raise ProtocolError(f"bad binary frame magic {magic!r}")
    if version != BIN_VERSION:
        # Version skew is a STRUCTURED error, never a misparse: a v2
        # sender against this v1 receiver must fail loudly here.
        raise ProtocolError(
            f"unsupported binary frame version {version} (speak {BIN_VERSION})"
        )
    rest = frame[_BIN_HEADER.size :]
    if meta_len > len(rest):
        raise ProtocolError(
            f"binary frame meta_len {meta_len} exceeds body ({len(rest)}B)"
        )
    meta_b, body = rest[:meta_len], rest[meta_len:]
    signed = bytes((version, flags, reserved)) + meta_b + body
    if not hmac.compare_digest(mac, _mac_raw(secret, signed)):
        raise PermissionError("bad HMAC — rejecting binary frame")
    compressed = bool(flags & FLAG_ZLIB)
    if compressed:
        try:
            # Bounded decompression: MAX_FRAME is a RESOURCE bound, and a
            # <64MiB body of compressed zeros could otherwise expand to
            # tens of GiB (zlib ~1000:1) before anyone checks anything.
            # Valid payloads fit a frame uncompressed, so cap the output.
            d = zlib.decompressobj()
            out = d.decompress(body, MAX_FRAME + 1)
            if len(out) > MAX_FRAME or d.unconsumed_tail:
                raise ProtocolError(
                    "zlib payload decompresses beyond MAX_FRAME "
                    f"({MAX_FRAME}B) — rejecting frame"
                )
            if not d.eof:
                raise ProtocolError(
                    "corrupt zlib payload in binary frame: truncated stream"
                )
            body = out
        except zlib.error as e:
            # MAC passed, so the sender compressed garbage (e.g. a fault
            # injected before framing): structured, attributable error.
            raise ProtocolError(f"corrupt zlib payload in binary frame: {e}")
    try:
        meta = json.loads(meta_b)
    except ValueError:
        raise ProtocolError("binary frame meta is not valid JSON")
    if not isinstance(meta, dict):
        raise ProtocolError("binary frame meta must be a JSON object")
    return FrameIn(
        obj=meta,
        payload=body,
        wire_bytes=wire_bytes,
        binary=True,
        compressed=compressed,
    )


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()  # linear-time accumulation (frames can be ~64MB TSVs)
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


class ReplayGuard:
    """Worker-side freshness check: bounded-age timestamps + one-shot nonces.

    Thread-safe: the worker serves connections concurrently, so the nonce
    set is mutated under a lock.
    """

    def __init__(self, window: float = REPLAY_WINDOW_SECS):
        import threading

        self.window = window
        self._seen: dict[str, float] = {}
        self._lock = threading.Lock()

    def check(self, req: dict) -> None:
        now = time.time()
        ts = req.get("_ts")
        nonce = req.get("_nonce")
        if not isinstance(ts, (int, float)) or not isinstance(nonce, str):
            raise PermissionError("missing freshness stamp — rejecting frame")
        if abs(now - ts) > self.window:
            raise PermissionError("stale frame — rejecting (possible replay)")
        with self._lock:
            # Prune expired nonces, then enforce one-shot use.
            for n, t in list(self._seen.items()):
                if now - t > self.window:
                    del self._seen[n]
            if nonce in self._seen:
                raise PermissionError("nonce reuse — rejecting replayed frame")
            self._seen[nonce] = now


def parse_cluster_file(path: str) -> list[tuple[str, int]]:
    """Parse the reference's documented ``ip_address port`` cluster file
    (reference README.md:18-22): one ``host port`` per line, ``#``
    comments and blank lines skipped."""
    nodes = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"bad cluster line (want 'ip port'): {raw!r}")
            nodes.append((parts[0], int(parts[1])))
    if not nodes:
        raise ValueError(f"cluster file {path!r} has no nodes")
    return nodes
