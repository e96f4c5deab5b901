"""Distributor master: the launcher the reference documents but never shipped.

Port of ``locust_tpu/distributor/master.py``.  The reference README
promises a script that "will launch the MapReduce program for all nodes"
over a cluster file of ``ip port`` lines (reference README.md:18-24); no
such script exists there.  This module implements that role:

  1. parse the cluster file (protocol.parse_cluster_file),
  2. shard the input by line ranges, the reference's per-node
     ``[line_start, line_end)`` CLI contract (main.cu:369-374),
  3. fan the staged map out to all workers in parallel (each worker runs
     the port's stage-1 CLI, on the card unless the passthrough says
     ``--backend cpu``),
  4. collect each node's intermediate (packed binary KV by default, TSV
     for reference parity) over the authenticated channel: pipelined
     offset-addressed chunks over one connection per node, binary frames
     with optional zlib when the worker speaks them, sha256-verified per
     raw chunk AND end to end against the digest the worker recorded at
     map time,
  5. run the reduce stage locally over all collected intermediates, the
     port's stage-2 CLI in this process, which sorts again.

Fault tolerance, per Dean & Ghemawat's OSDI'04 recipe (re-execution,
backup tasks, checksummed data):

  * a shard whose worker fails (dead connection, timeout, non-zero map
    exit, integrity mismatch) is REASSIGNED to the next live worker,
    bounded by ``max_retries`` failed attempts per shard;
  * a failed worker is QUARANTINED with exponential backoff + jitter
    (``WorkerHealth``); a heartbeat loop pings quarantined workers once
    their backoff expires and un-quarantines them on recovery;
  * a shard still running past ``speculate_after`` seconds gets a
    SPECULATIVE backup attempt on a different worker; the first finisher
    wins (line-range shards are deterministic, and every attempt writes
    an attempt-unique intermediate path, so the loser cannot clobber the
    winner);
  * per-shard attempt timings land in the returned ``JobResult.shards``.

Fault sites (utils/faultplan.py): ``rpc.connect`` before every
connection; the workers fire the others.  The master speaks the JAX
master's wire protocol and request keys, so either package's master
drives either package's workers.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import hashlib
import logging
import os
import queue
import socket
import sys
import tempfile
import threading
import time
import uuid

from locust_tpu_torch import obs
from locust_tpu_torch.distributor import protocol
from locust_tpu_torch.io.loader import count_lines
from locust_tpu_torch.utils import faultplan

logger = logging.getLogger("locust_tpu_torch")


class MasterError(RuntimeError):
    pass


class IntegrityError(MasterError):
    """A fetched intermediate failed sha256 verification."""


def _scoped_call(tracer, fn, *args, **kw):
    """Run ``fn(*args, **kw)`` with the obs thread-local pinned to
    ``tracer`` — the ONE copy of the pool-thread scoping rule: worker
    threads otherwise fall back to the process tracer, which need not be
    the one the job was scoped to (or may leak spans a scoped(None)
    caller masked off)."""
    with obs.scoped(tracer):
        return fn(*args, **kw)


def rpc(node: tuple[str, int], req: dict, secret: bytes, timeout: float = 1800.0) -> dict:
    """One request/reply against a worker on a fresh connection — the
    control-plane primitive shared by ``run_job`` and the serve
    tier's warm-cache RPCs (``serve_stats``, serve/pool.py)."""
    faultplan.check_connect(node[0], node[1])
    with socket.create_connection(node, timeout=timeout) as sock:
        protocol.send_frame(sock, req, secret)
        return protocol.recv_frame(sock, secret)


_rpc = rpc  # internal call sites predate the public name


def _verify_chunk(obj: dict, data: bytes, node, offset: int) -> None:
    # Per-chunk digest over the RAW window: catches corruption between
    # the worker's disk read and this process (the HMAC covers the
    # frame, but not a worker-side read or encode gone wrong).
    chunk_sha = obj.get("sha256")
    if chunk_sha is not None and chunk_sha != hashlib.sha256(data).hexdigest():
        raise IntegrityError(
            f"fetch chunk at offset {offset} from {node} failed "
            "sha256 verification"
        )


def _verify_whole(whole, expect_sha, remote, node) -> None:
    # End-to-end digest: the worker hashed the intermediate at map
    # time, so any corruption after the map — disk rot, a truncated
    # read, a lying chunk stream — surfaces here, not as wrong counts.
    if expect_sha is not None and whole.hexdigest() != expect_sha:
        raise IntegrityError(
            f"intermediate {remote} from {node} failed end-to-end sha256 "
            "verification (corrupted after map)"
        )


def _fetch_via_rpc(
    node, remote: str, expect_sha, stats: dict, f, whole,
    rpc, secret: bytes, chunk_bytes: int, offset: int = 0,
) -> None:
    """Chunk loop through an ``rpc`` callable: the pre-binary path, used
    when the caller injected an rpc (tests intercept every chunk there)
    or after a JSON-only worker answered the negotiation.  ``wire_bytes``
    counts the base64 text (the dominant term; exact wire framing is
    only visible on the socket path)."""
    while True:
        got = rpc(
            node,
            {"cmd": "fetch", "path": remote, "offset": offset,
             "max_bytes": chunk_bytes},
            secret,
        )
        if got.get("status") != "ok":
            raise MasterError(
                f"fetch failed on node {node}: {got.get('error')}"
            )
        b64 = got.get("data_b64", "")
        data = base64.b64decode(b64)
        _verify_chunk(got, data, node, offset)
        f.write(data)
        whole.update(data)
        offset += len(data)
        stats["bytes"] += len(data)
        stats["wire_bytes"] += len(b64)
        stats["chunks"] += 1
        if got.get("eof", True) or not data:
            break
    _verify_whole(whole, expect_sha, remote, node)


def _fetch_pipelined(
    node, remote: str, expect_sha, stats: dict, f, whole,
    secret: bytes, chunk_bytes: int, window: int, use_zlib: bool,
    rpc, timeout: float,
) -> None:
    """Windowed fetch over ONE connection: up to ``window`` chunk
    requests in flight, answered strictly in order by the worker.  The
    first reply tells binary support and the file size; a JSON reply
    means a pre-binary peer (which may close after one reply), so the
    transfer degrades to the per-request ``rpc`` loop."""
    faultplan.check_connect(node[0], node[1])
    with socket.create_connection(node, timeout=timeout) as sock:
        sock.settimeout(timeout)
        stamp = protocol.trace_stamp()  # chunk replies echo it in meta

        def send_req(off: int) -> None:
            req = {"cmd": "fetch", "path": remote, "offset": off,
                   "max_bytes": chunk_bytes, "bin": 1}
            if use_zlib:
                req["accept_zlib"] = True
            if stamp is not None:
                req[protocol.TRACE_KEY] = stamp
            protocol.send_frame(sock, req, secret)

        send_req(0)
        next_off = None  # unknown until the first reply carries total
        total = None
        expected = 0  # next offset we must receive
        inflight = 1
        while True:
            fr = protocol.recv_frame_ex(sock, secret)
            inflight -= 1
            obj = fr.obj
            if obj.get("status") != "ok":
                raise MasterError(
                    f"fetch failed on node {node}: {obj.get('error')}"
                )
            data = (
                fr.payload
                if fr.binary
                else base64.b64decode(obj.get("data_b64", ""))
            )
            got_off = int(obj.get("offset", expected))
            if got_off != expected:
                raise IntegrityError(
                    f"out-of-order fetch chunk from {node}: got offset "
                    f"{got_off}, expected {expected}"
                )
            _verify_chunk(obj, data, node, got_off)
            f.write(data)
            whole.update(data)
            expected += len(data)
            stats["bytes"] += len(data)
            stats["wire_bytes"] += fr.wire_bytes
            stats["chunks"] += 1
            stats["zlib"] = stats["zlib"] or fr.compressed
            if not fr.binary:
                # Pre-binary peer: drop to the per-request path for the
                # rest of the file (it may close this socket any time).
                # One chunk is already on disk.
                stats["binary"] = False
                if obj.get("eof", True) or not data:
                    _verify_whole(whole, expect_sha, remote, node)
                    return
                return _fetch_via_rpc(
                    node, remote, expect_sha, stats, f, whole,
                    rpc, secret, chunk_bytes, offset=expected,
                )
            if total is None:
                total = int(obj.get("total", 0))
                next_off = chunk_bytes
            # Keep the window full: schedule more chunk requests as long
            # as un-requested bytes remain.
            while inflight < window and next_off is not None and next_off < total:
                send_req(next_off)
                next_off += chunk_bytes
                inflight += 1
            if (obj.get("eof") or not data) and inflight == 0:
                break
        _verify_whole(whole, expect_sha, remote, node)


def fetch_file(
    node: tuple[str, int],
    remote: str,
    local: str,
    secret: bytes,
    expect_sha: str | None = None,
    rpc=None,
    rpc_timeout: float = 1800.0,
    use_binary: bool = True,
    use_zlib: bool = True,
    window: int = 4,
    chunk_bytes: int | None = None,
) -> dict:
    """One verified intermediate transfer; returns the per-fetch stats
    dict (payload/wire bytes, chunks, binary/zlib, elapsed, MB/s) that
    lands in ``JobResult.shards``, also the microbench's measuring
    primitive (microbench.py).  A custom ``rpc`` routes
    every chunk through it (unpipelined) so tests can intercept."""
    # Clamp to the worker's own window cap: the pipelined scheduler
    # derives offsets from the REQUESTED size, so requesting more than
    # the worker will ever return (worker clamps to FETCH_CHUNK_MAX)
    # would desync offsets into a bogus out-of-order IntegrityError.
    chunk = max(1, min(int(chunk_bytes or protocol.FETCH_CHUNK),
                       protocol.FETCH_CHUNK_MAX))
    window = max(1, int(window))
    stats = {
        "node": list(node), "bytes": 0, "wire_bytes": 0, "chunks": 0,
        "binary": bool(use_binary and rpc is None),
        "zlib": False, "window": window, "elapsed_s": None, "mb_s": None,
    }
    t0 = time.perf_counter()
    whole = hashlib.sha256()
    rpc_fn = rpc or (lambda nd, rq, s: _rpc(nd, rq, s, timeout=rpc_timeout))
    # One span per transfer = one fetch-pipeline window on the timeline;
    # byte/throughput metrics aggregate across every fetch of the job.
    with obs.span(
        "master.fetch",
        node=f"{node[0]}:{node[1]}", path=remote,
        window=window, chunk_bytes=chunk,
    ):
        with open(local, "wb") as f:
            if rpc is None and use_binary:
                _fetch_pipelined(
                    node, remote, expect_sha, stats, f, whole,
                    secret, chunk, window, use_zlib, rpc_fn, rpc_timeout,
                )
            else:
                stats["binary"] = False
                _fetch_via_rpc(
                    node, remote, expect_sha, stats, f, whole,
                    rpc_fn, secret, chunk,
                )
    stats["elapsed_s"] = round(time.perf_counter() - t0, 6)
    if stats["elapsed_s"] > 0:
        stats["mb_s"] = round(stats["bytes"] / 1e6 / stats["elapsed_s"], 3)
    obs.metric_inc("fetch.bytes", stats["bytes"])
    if stats["mb_s"]:
        obs.metric_observe("fetch.mb_s", stats["mb_s"])
    return stats


class WorkerHealth:
    """Per-worker liveness with exponential backoff + deterministic jitter.

    A failure quarantines the worker for ``base_s * 2**(consecutive-1)``
    seconds (capped at ``cap_s``), stretched by up to ``jitter`` fraction
    of deterministic (seeded) noise so a fleet of masters doesn't re-probe
    a recovering worker in lockstep.  ``ok()`` clears the slate — the
    un-quarantine-on-recovery half of the contract.  Injectable ``clock``
    keeps the unit tests fake-clock deterministic (tests/test_faults.py).
    Thread-safe: the shard tasks and the heartbeat loop mutate it
    concurrently.
    """

    def __init__(
        self,
        n: int,
        clock=time.monotonic,
        base_s: float = 0.5,
        cap_s: float = 30.0,
        jitter: float = 0.5,
        seed: int = 0,
    ):
        self.n = n
        self.clock = clock
        self.base_s = base_s
        self.cap_s = cap_s
        self.jitter = jitter
        self.seed = seed
        self._failures = [0] * n
        self._until = [0.0] * n
        self._lock = threading.Lock()

    def fail(self, idx: int) -> float:
        """Record a failure; returns the backoff applied (seconds)."""
        with self._lock:
            self._failures[idx] += 1
            f = self._failures[idx]
            back = min(self.cap_s, self.base_s * (2 ** (f - 1)))
            back *= 1.0 + self.jitter * self._unit(idx, f)
            self._until[idx] = self.clock() + back
            return back

    def ok(self, idx: int) -> None:
        with self._lock:
            self._failures[idx] = 0
            self._until[idx] = 0.0

    def healthy(self, idx: int) -> bool:
        """Never-failed-recently: not quarantined at all."""
        with self._lock:
            return self._failures[idx] == 0

    def probe_due(self, idx: int) -> bool:
        """Quarantined AND its backoff has expired: eligible for a
        heartbeat probe (or a direct work attempt, which doubles as one)."""
        with self._lock:
            return self._failures[idx] > 0 and self.clock() >= self._until[idx]

    def quarantined(self, idx: int) -> bool:
        with self._lock:
            return self._failures[idx] > 0 and self.clock() < self._until[idx]

    def failures(self, idx: int) -> int:
        with self._lock:
            return self._failures[idx]

    def _unit(self, idx: int, f: int) -> float:
        """Deterministic jitter in [0, 1): seeded, not wall-clock."""
        h = hashlib.sha256(f"{self.seed}:{idx}:{f}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64


class ShardStats:
    """Timing/attempt record for one shard (JobResult.shards).

    Each attempt dict additionally carries a ``fetch`` sub-dict once its
    intermediate transfer ran: payload/wire byte counts, chunk count,
    window, whether binary framing and zlib were used, elapsed seconds
    and MB/s: the per-node data-plane evidence.
    """

    def __init__(self, shard: int):
        self.shard = shard
        self.attempts: list[dict] = []  # worker, speculative, t0, t1, outcome
        self.winner: int | None = None  # worker index that produced the file
        self.speculated = False
        self.elapsed_s: float | None = None

    def as_dict(self) -> dict:
        return {
            "shard": self.shard,
            "winner": self.winner,
            "speculated": self.speculated,
            "elapsed_s": self.elapsed_s,
            "attempts": list(self.attempts),
        }


class JobResult(list):
    """The collected local intermediate paths (list API unchanged for
    callers that only reduce), plus per-shard timing stats, the final
    health view, and — when telemetry was enabled — the job's merged
    cross-node trace."""

    def __init__(self, paths, shards: list[ShardStats], health: WorkerHealth,
                 trace=None):
        super().__init__(paths)
        self.shards = shards
        self.health = health
        self._trace = trace

    def timeline(self) -> dict | None:
        """The merged cross-node Chrome-trace document: master spans plus
        every worker's shipped span list, clock-offset-adjusted into the
        master clock under one trace_id.  None
        when telemetry was disabled for the job.  Deliberately carries NO
        metrics snapshot: the job tracer's spans are per-job, but metrics
        are process-scoped (concurrent jobs share them) — the process
        snapshot belongs to ``obs.export`` (the master CLI's trace file),
        not to one job's timeline."""
        if self._trace is None:
            return None
        return self._trace.to_chrome()

    def dataplane(self) -> dict:
        """Aggregate data-plane stats over every completed fetch."""
        fetches = [
            a["fetch"]
            for s in self.shards
            for a in s.attempts
            if isinstance(a.get("fetch"), dict)
        ]
        payload = sum(f.get("bytes", 0) for f in fetches)
        wire = sum(f.get("wire_bytes", 0) for f in fetches)
        elapsed = sum(f.get("elapsed_s") or 0.0 for f in fetches)
        return {
            "fetches": len(fetches),
            "payload_bytes": payload,
            "wire_bytes": wire,
            "chunks": sum(f.get("chunks", 0) for f in fetches),
            "binary": all(f.get("binary") for f in fetches) if fetches else False,
            "zlib": any(f.get("zlib") for f in fetches),
            "fetch_mb_s": round(payload / 1e6 / elapsed, 3) if elapsed > 0 else None,
            "compression_ratio": round(payload / wire, 3) if wire else None,
        }


def _heartbeat_loop(
    stop: threading.Event,
    health: WorkerHealth,
    cluster: list[tuple[str, int]],
    rpc,
    secret: bytes,
    interval: float,
) -> None:
    """Ping quarantined workers whose backoff expired; un-quarantine on a
    good pong, deepen the backoff otherwise.  Runs until the job ends."""
    while not stop.wait(interval):
        try:
            for idx in range(len(cluster)):
                if stop.is_set():
                    return
                if not health.probe_due(idx):
                    continue
                try:
                    resp = rpc(cluster[idx], {"cmd": "ping"}, secret)
                    if resp.get("pong"):
                        health.ok(idx)
                        logger.info(
                            "worker %d recovered; un-quarantined", idx
                        )
                    else:
                        health.fail(idx)
                except (OSError, MasterError, ValueError, PermissionError):
                    health.fail(idx)
        except Exception:  # noqa: BLE001 - a surprise here (health
            # bookkeeping, logging) must not kill the heartbeat: with it
            # dead, quarantined workers stay quarantined FOREVER and the
            # job narrows to the survivors one fault at a time.
            logger.warning(
                "heartbeat pass failed; retrying next interval",
                exc_info=True,
            )


def run_job(
    cluster: list[tuple[str, int]],
    input_file: str,
    secret: bytes,
    workdir: str | None = None,
    extra_args: list[str] | None = None,
    rpc=None,
    max_retries: int = 2,
    rpc_timeout: float = 1800.0,
    heartbeat_interval: float = 2.0,
    ping_timeout: float = 10.0,
    speculate_after: float | None = None,
    health: WorkerHealth | None = None,
    poll_s: float = 0.05,
    inter_format: str = "bin",
    use_binary: bool = True,
    use_zlib: bool = True,
    fetch_window: int = 4,
    fetch_chunk: int | None = None,
    max_parallel_fetch: int | None = None,
) -> JobResult:
    """Fan out map stages, collect + verify intermediates; returns a
    ``JobResult`` (local paths for the reduce, plus ``.shards`` stats).

    Data plane: workers write packed binary KV
    intermediates (``inter_format="bin"``; ``"tsv"`` restores reference
    parity) and the master pulls them with ``fetch_window`` chunk
    requests pipelined down one connection per fetch, binary frames with
    raw (optionally zlib) payloads when the worker speaks them — a
    JSON-only worker transparently degrades to the base64 per-request
    path.  Concurrent fetches across nodes run on a bounded pool of
    ``max_parallel_fetch`` (default ``min(8, len(cluster))``).  A custom
    ``rpc`` (tests) routes every chunk through it instead, unpipelined.

    Each of the ``len(cluster)`` line-range shards tolerates up to
    ``max_retries`` FAILED attempts (each on a distinct worker) before the
    job fails with ``MasterError``.  ``speculate_after`` seconds after a
    shard's latest attempt started with no finisher, one speculative
    backup attempt launches on a different worker — first success wins
    (None disables speculation).  All waits are bounded: RPCs by
    ``rpc_timeout`` and the scheduler poll by ``poll_s``, so a straggling
    or injected-faulty worker can delay but never hang the job.
    """
    n = len(cluster)
    total = count_lines(input_file)
    per = -(-total // n) if total else 1
    workdir = workdir or tempfile.mkdtemp(prefix="locust_master_")
    os.makedirs(workdir, exist_ok=True)
    # Unique per-job intermediate names: concurrent jobs against the same
    # worker pool must not clobber each other's TSVs.
    job_id = uuid.uuid4().hex[:12]
    # Cross-node telemetry: when a tracer is
    # active, every map request carries its trace_id + shard, workers run
    # under request-scoped child tracers and ship serialized span lists
    # back in their replies, and _ingest_worker_spans merges them —
    # shifted by the reply-time clock-offset estimate — into ONE
    # timeline, surfaced as JobResult.timeline().
    tracer = obs.current()
    obs.metric_set("job.workers", n)

    def _ingest_worker_spans(resp, node, t_recv: float) -> None:
        """Merge a reply's shipped spans (ok AND error replies carry
        them).  Offset estimate: the worker stamps its wall clock while
        building the reply, so worker_clock ≈ master t_recv minus the
        one-way reply latency — good to ~net/2, plenty for timelines."""
        if tracer is None or not isinstance(resp, dict):
            return
        spans = resp.get("spans")
        if not spans:
            return
        clock = resp.get("clock")
        offset = float(clock) - t_recv if isinstance(clock, (int, float)) else 0.0
        tracer.ingest(
            spans, offset_s=offset, process=f"worker {node[0]}:{node[1]}"
        )

    health = health or WorkerHealth(n)
    if inter_format not in ("tsv", "bin"):
        raise ValueError(f"unknown inter_format {inter_format!r}")
    # An injected rpc (tests) must see EVERY chunk — the socket-pipelined
    # path would bypass it, so it forces the per-request loop.
    rpc_is_default = rpc is None
    if rpc is None:
        def rpc(node, req, s, _to=rpc_timeout):  # noqa: E306
            return _rpc(node, req, s, timeout=_to)

        # Heartbeat pings are LIVENESS checks: a worker that accepts TCP
        # but never replies must cost the serial probe loop seconds, not
        # the map-stage timeout; otherwise one hung ping disables recovery
        # probing for the rest of the job.
        def ping_rpc(node, req, s, _to=ping_timeout):
            return _rpc(node, req, s, timeout=_to)
    else:
        ping_rpc = rpc

    # Bounded fetch pool: shard attempt threads hand their transfer to
    # this pool, so at most ``max_parallel_fetch`` node fetches run at
    # once however many shards are in flight (each fetch is already
    # pipelined internally; unbounded concurrency would just thrash the
    # master's NIC and disk).
    fetch_pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=int(max_parallel_fetch or min(8, max(1, n))),
        thread_name_prefix="locust-fetch",
    )

    def fetch_chunked(
        node, remote: str, local: str, expect_sha: str | None
    ) -> dict:
        """One intermediate transfer through the bounded fetch pool;
        returns the per-fetch stats dict (JobResult.shards evidence)."""
        try:
            fut = fetch_pool.submit(
                _scoped_call, tracer, fetch_file,
                node, remote, local, secret,
                expect_sha=expect_sha,
                rpc=None if rpc_is_default else rpc,
                rpc_timeout=rpc_timeout,
                use_binary=use_binary,
                use_zlib=use_zlib,
                window=fetch_window,
                chunk_bytes=fetch_chunk,
            )
        except RuntimeError as e:
            # An abandoned speculative/retry loser can reach here AFTER
            # the job finished and the pool shut down: a failed attempt,
            # not an unhandled thread death.
            raise MasterError(f"fetch pool closed (job ended): {e}")
        # Bounded wait: the fetch itself is bounded by per-socket
        # timeouts, but a saturated pool queues this future behind other
        # transfers — one rpc_timeout of queueing slack on top of the
        # transfer's own budget keeps a wedged peer from parking this
        # attempt thread forever.
        try:
            return fut.result(timeout=rpc_timeout * 2)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise MasterError(
                f"fetch of {remote} from {node} did not complete within "
                f"{rpc_timeout * 2:.0f}s (pool saturated or peer wedged)"
            )

    def try_shard(shard: int, node_idx: int, attempt: int) -> tuple[str, dict]:
        node = cluster[node_idx]
        start, end = shard * per, min((shard + 1) * per, total)
        # Attempt-unique remote/local paths: a speculative loser must not
        # clobber the winner's file (loopback runs share one temporary
        # directory, which is also the workers' default workdir).
        ext = "kvb" if inter_format == "bin" else "tsv"
        inter = os.path.join(
            tempfile.gettempdir(), f"locust_{job_id}_shard{shard}_a{attempt}.{ext}"
        )
        req = {
            "cmd": "map",
            "file": input_file,
            "line_start": start,
            "line_end": end,
            "node_num": shard,
            "intermediate": inter,
            "inter_format": inter_format,
            "extra_args": extra_args or [],
        }
        # Attempt threads run scoped to the job's tracer (_run_scoped /
        # attempt()), so the one stamp helper sees the right trace_id.
        stamp = protocol.trace_stamp(shard)
        if stamp is not None:
            req[protocol.TRACE_KEY] = stamp
        with obs.span("master.map_rpc", shard=shard, worker=node_idx,
                      attempt=attempt):
            resp = rpc(node, req, secret)
        _ingest_worker_spans(resp, node, time.time())
        if resp.get("status") != "ok":
            raise MasterError(
                f"map failed on node {node}: rc={resp.get('returncode')} "
                f"err={resp.get('error', '')}\n{resp.get('log', '')}"
            )
        local = os.path.join(workdir, f"node{shard}.a{attempt}.{ext}")
        fstats = fetch_chunked(node, inter, local, resp.get("sha256"))
        return local, fstats

    def pick_node(shard: int, tried: set[int], busy: set[int]) -> int | None:
        """Next worker for this shard: home node first, then rotation;
        healthy workers before quarantine-expired ones (a work attempt on
        an expired-quarantine worker doubles as its heartbeat probe);
        never one still inside its backoff window or already running an
        attempt for this shard.  Once EVERY worker has been tried, a
        recovered (or probe-eligible) one may be re-tried: two transient
        flaps must not exhaust a two-worker pool while retry budget
        remains — total attempts stay bounded by ``max_retries``."""
        order = [(shard + k) % n for k in range(n)]
        for idx in order:
            if idx not in tried and idx not in busy and health.healthy(idx):
                return idx
        for idx in order:
            if idx not in tried and idx not in busy and health.probe_due(idx):
                return idx
        if all(i in tried for i in order):
            for idx in order:
                if idx not in busy and (
                    health.healthy(idx) or health.probe_due(idx)
                ):
                    return idx
        return None

    def one(shard: int) -> tuple[str, ShardStats]:
        stats = ShardStats(shard)
        shard_t0 = time.perf_counter()
        done_q: queue.Queue = queue.Queue()
        tried: set[int] = set()
        pending: dict[int, dict] = {}  # attempt id -> {"worker", "t0", ...}
        seq = 0
        failed_attempts = 0
        last_err: Exception | None = None
        last_launch = time.perf_counter()
        speculation_spent = False

        def launch(speculative: bool) -> bool:
            nonlocal seq, last_launch
            busy = {r["worker"] for r in pending.values()}
            node_idx = pick_node(shard, tried, busy)
            if node_idx is None:
                return False
            tried.add(node_idx)
            aid = seq
            seq += 1
            rec = {
                "worker": node_idx,
                "speculative": speculative,
                "t0": time.perf_counter() - shard_t0,
                "t1": None,
                "outcome": "running",
            }
            stats.attempts.append(rec)
            last_launch = time.perf_counter()

            def attempt() -> None:
                try:
                    local = _scoped_call(
                        tracer, try_shard, shard, node_idx, aid
                    )
                    done_q.put((aid, node_idx, rec, local, None))
                except (MasterError, OSError, ValueError) as e:
                    done_q.put((aid, node_idx, rec, None, e))
                except Exception as e:  # noqa: BLE001 - an attempt thread
                    # must NEVER die unhandled (pytest turns that into a
                    # spurious failure in whatever test runs next); an
                    # unexpected type is still just a failed attempt.
                    done_q.put(
                        (aid, node_idx, rec, None,
                         MasterError(f"{type(e).__name__}: {e}"))
                    )

            threading.Thread(target=attempt, daemon=True).start()
            pending[aid] = rec
            if speculative:
                stats.speculated = True
                logger.info(
                    "shard %d straggling; speculative backup on worker %d",
                    shard, node_idx,
                )
            return True

        def launch_or_wait() -> bool:
            """Launch a retry, WAITING (bounded by the backoff cap) for a
            quarantined worker to become probe-eligible: a cluster-wide
            transient flap — every worker backing off at once — must cost
            seconds of patience, not the whole job.  Returns False only
            when the bounded wait expired with no launchable worker."""
            deadline = time.perf_counter() + health.cap_s + 1.0
            while time.perf_counter() < deadline:
                if launch(speculative=False):
                    return True
                time.sleep(poll_s)
            return False

        if not launch_or_wait():
            raise MasterError(
                f"shard {shard} failed on every tried worker "
                f"(max_retries={max_retries}): no live worker to start on"
            )
        while True:
            try:
                aid, node_idx, rec, local, err = done_q.get(timeout=poll_s)
            except queue.Empty:
                if (
                    speculate_after is not None
                    and not speculation_spent
                    and pending
                    and time.perf_counter() - last_launch >= speculate_after
                ):
                    # One backup per shard: Dean & Ghemawat's backup tasks,
                    # not an unbounded fork-bomb.  A failed pick (no spare
                    # worker) also spends the budget — re-polling an empty
                    # pool every tick buys nothing.
                    speculation_spent = True
                    launch(speculative=True)
                continue
            rec["t1"] = time.perf_counter() - shard_t0
            if err is None:
                local, rec["fetch"] = local
                rec["outcome"] = "ok"
                health.ok(node_idx)
                for other in pending.values():
                    if other is not rec and other["outcome"] == "running":
                        other["outcome"] = "cancelled"  # abandoned loser
                stats.winner = node_idx
                stats.elapsed_s = time.perf_counter() - shard_t0
                return local, stats
            pending.pop(aid, None)
            rec["outcome"] = (
                "integrity" if isinstance(err, IntegrityError) else "error"
            )
            last_err = err
            failed_attempts += 1
            back = health.fail(node_idx)
            logger.warning(
                "shard %d attempt on worker %d failed (%s); worker backed "
                "off %.2fs", shard, node_idx, err, back,
            )
            if failed_attempts > max_retries and not pending:
                break
            if not pending and not launch_or_wait():
                break
        raise MasterError(
            f"shard {shard} failed on every tried worker "
            f"(max_retries={max_retries}): {last_err}"
        )

    stop = threading.Event()
    hb = threading.Thread(
        target=_heartbeat_loop,
        args=(stop, health, cluster, ping_rpc, secret, heartbeat_interval),
        daemon=True,
    )
    hb.start()
    try:
        with obs.span("job.run", job=job_id, workers=n, input=input_file):
            with concurrent.futures.ThreadPoolExecutor(max_workers=n) as ex:
                # The per-shard threads likewise pin to the job's tracer.
                results = list(
                    ex.map(
                        lambda shard: _scoped_call(tracer, one, shard),
                        range(n),
                    )
                )
    finally:
        stop.set()
        fetch_pool.shutdown(wait=False)
    paths = [p for p, _ in results]
    shards = [s for _, s in results]
    for s in shards:
        logger.info(
            "shard %d: %.3fs on worker %s (%d attempt(s)%s)",
            s.shard, s.elapsed_s or -1.0, s.winner, len(s.attempts),
            ", speculated" if s.speculated else "",
        )
    return JobResult(paths, shards, health, trace=tracer)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="locust-torch-master")
    p.add_argument("cluster_file", help="lines of 'ip port' (reference README.md:18-22)")
    p.add_argument("input_file")
    p.add_argument("--secret-env", default="LOCUST_SECRET")
    p.add_argument("--workdir", default=None)
    p.add_argument("--max-retries", type=int, default=2)
    p.add_argument("--speculate-after", type=float, default=None,
                   help="seconds before a straggling shard gets a "
                        "speculative backup attempt (default: disabled)")
    p.add_argument("--inter-format", choices=["tsv", "bin"], default="bin",
                   help="intermediate format workers write (bin = packed "
                        "binary KV; tsv = reference parity)")
    p.add_argument("--fetch-window", type=int, default=4,
                   help="chunk requests kept in flight per node fetch")
    p.add_argument("--fetch-chunk", type=int, default=None,
                   help=f"bytes per fetch chunk (default {protocol.FETCH_CHUNK})")
    p.add_argument("--json-plane", action="store_true",
                   help="disable binary framing: base64 JSON chunks "
                        "(interop/debugging)")
    p.add_argument("--no-zlib", action="store_true",
                   help="disable wire compression of fetch chunks")
    p.add_argument("--fault-plan", default=None,
                   help="fault injection plan: JSON text or a path "
                        f"(also ${faultplan.ENV_VAR})")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="structured telemetry: record master spans, merge "
                        "every worker's shipped map spans under one "
                        "trace_id, and export the job as Chrome-trace/"
                        "Perfetto JSON to FILE")
    args, passthrough = p.parse_known_args(argv)
    faultplan.install(args.fault_plan)
    if args.trace_out:
        obs.enable(process="master")
    try:
        return _main(args, passthrough)
    finally:
        if args.trace_out:
            # Export on EVERY path — a failed chaos run's timeline is
            # the one worth reading; and a broken export must not mask
            # the run's own outcome (telemetry never takes down a job).
            try:
                obs.export(args.trace_out)
                print(f"[master] trace written to {args.trace_out}",
                      file=sys.stderr)
            except OSError as e:
                print(f"[master] trace export to {args.trace_out} "
                      f"failed: {e}", file=sys.stderr)
            obs.disable()


def _main(args, passthrough) -> int:
    secret = os.environ.get(args.secret_env, "").encode()
    if not secret:
        print(f"error: set ${args.secret_env}", file=sys.stderr)
        return 2
    cluster = protocol.parse_cluster_file(args.cluster_file)
    print(f"[master] {len(cluster)} worker(s)", file=sys.stderr)
    tsvs = run_job(cluster, args.input_file, secret,
                   workdir=args.workdir, extra_args=passthrough,
                   max_retries=args.max_retries,
                   speculate_after=args.speculate_after,
                   inter_format=args.inter_format,
                   use_binary=not args.json_plane,
                   use_zlib=not args.no_zlib,
                   fetch_window=args.fetch_window,
                   fetch_chunk=args.fetch_chunk)
    for s in tsvs.shards:
        print(
            f"[master] shard {s.shard}: {s.elapsed_s:.3f}s on worker "
            f"{s.winner}, {len(s.attempts)} attempt(s)"
            + (", speculated" if s.speculated else ""),
            file=sys.stderr,
        )
    dp = tsvs.dataplane()
    print(
        f"[master] dataplane: {dp['payload_bytes']}B payload / "
        f"{dp['wire_bytes']}B wire in {dp['chunks']} chunk(s), "
        f"binary={dp['binary']} zlib={dp['zlib']} "
        f"fetch={dp['fetch_mb_s']} MB/s",
        file=sys.stderr,
    )

    # Local reduce over all collected TSVs (stage 2; re-sorts — Q6 fix).
    from locust_tpu_torch import cli

    reduce_args = [args.input_file, "-1", "-1", "0", "2"]
    for t in tsvs:
        reduce_args += ["-i", t]
    # The exported timeline (main()'s finally) then holds master job
    # spans + every worker's map spans + the in-process reduce's spans.
    return cli.main(reduce_args + passthrough)


if __name__ == "__main__":
    raise SystemExit(main())
