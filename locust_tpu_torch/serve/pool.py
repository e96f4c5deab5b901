"""Scale-out serve dispatch: place batches on distributor workers.

The port's copy of the JAX package's ``serve/pool.py``, the same
placement, the same wire and the same stats, so a daemon of either
package drives ``--serve`` workers of either.  Without a pool every
batch folds on the daemon's single LOCAL engine; ``WorkerPool`` is the
placement layer between the daemon and the distributor's worker tier
(docs/SERVING.md "Scale-out dispatch"):

  * **registration + health**: a fixed worker roster, each with ONE
    persistent authenticated connection (distributor/protocol.py frames,
    the same wire the map/fetch plane rides) and the master's
    ``WorkerHealth`` exponential-backoff quarantine — a worker that
    kills a dispatch backs off and is re-probed by the next attempt;
  * **cache-affinity placement**: every worker runs its own warm
    ``ExecutableCache`` (serve/cache.py), and a cold placement pays the
    engine's first dispatch at the shape, so ``place()`` prefers the worker
    that already holds the warm executable for the batch's
    ``(workload, config fingerprint, shape bucket)`` key — affinity IS
    the throughput lever — and spills over to the least-loaded healthy
    worker only when the affine one is saturated (``max_inflight``);
  * **content-addressed corpus spill**: batch corpora move through the
    write-once ``<sha256>.bin`` spill files the job journal already
    keeps (serve/journal.py) instead of re-serializing per worker — a
    worker reads the spill path and VERIFIES the sha before folding, so
    a stale or torn spill is a structured error, never a silent wrong
    answer.  Workers must share the spill filesystem (loopback or a
    shared mount); there is no inline-bytes fallback on this path.

The floor is always the local engine: ``place()`` returning ``None``
(pool saturated, everyone quarantined, placement fault injected) routes
the batch to the daemon's own dispatch path, and a worker dying
mid-batch feeds the jobs back through the daemon's retry/bisection
ladder onto the survivors — never a dead daemon, never a lost job.

Chaos: the ``serve.place`` fault site fires inside ``place()`` ("error"
= placement failure, the batch falls back to the local engine and the
result stays byte-identical; "delay" = a slow placement decision).
Telemetry: the ``serve.place`` span wraps each placement decision and
``serve.affinity_hits`` counts warm-worker placements (closed obs
registry, R009).
"""

from __future__ import annotations

import hashlib
import logging
import os
import select
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from locust_tpu_torch import obs
from locust_tpu_torch.distributor import protocol
from locust_tpu_torch.utils import faultplan

logger = logging.getLogger("locust_tpu_torch")


class PoolDispatchError(RuntimeError):
    """A worker dispatch failed (connection death, structured worker
    error, injected fault).  The daemon's retry ladder absorbs it.
    ``code`` carries the worker's structured reason when it answered
    one — ``stale_epoch`` is the fencing rejection a demoted zombie
    primary must react to, not merely retry (docs/SERVING.md)."""

    def __init__(self, message: str, code: str | None = None,
                 epoch: int | None = None, lost_split: int | None = None,
                 lost_epoch: int | None = None):
        self.code = code
        self.epoch = epoch  # the rejecting side's fencing epoch, if sent
        # A reduce stage naming the map split whose partition input it
        # lost: the plan coordinator recomputes exactly that split
        # (docs/PLAN.md "Distributed execution"), not the whole plan.
        self.lost_split = lost_split
        # An iterate sweep naming the EPOCH whose shard partition it
        # lost (lost_split then names the shard): the coordinator
        # recomputes that (epoch, shard) stage from the epoch before
        # it, not the whole iteration history.
        self.lost_epoch = lost_epoch
        super().__init__(message)


def parse_worker_addr(spec) -> tuple[str, int]:
    """'host:port' (or an ``(host, port)`` pair) -> validated tuple."""
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        return str(spec[0]), int(spec[1])
    host, _, port = str(spec).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"worker address {spec!r} is not host:port")
    return host, int(port)


def _peer_closed(sock: socket.socket) -> bool:
    """Whether the peer closed this idle connection: it reads as ready
    with nothing in it (between requests a worker sends nothing)."""
    try:
        ready, _, _ = select.select([sock], [], [], 0)
        return bool(ready) and sock.recv(1, socket.MSG_PEEK) == b""
    except OSError:
        return True


class PoolWorker:
    """One pool member: address + its persistent connection.

    The connection is lazily dialed and serialized under ``_conn_lock``
    (the worker answers frames strictly in order, so one RPC at a time
    per connection); a failed RPC closes it and the next use redials,
    as does a use that finds the worker closed it (a worker drops a
    connection idle past its ``conn_timeout``).
    """

    def __init__(self, idx: int, addr: tuple[str, int]):
        self.idx = idx
        self.addr = addr
        self.name = f"{addr[0]}:{addr[1]}"
        self._conn: socket.socket | None = None
        self._conn_lock = threading.Lock()

    def _connect(self, timeout: float) -> socket.socket:
        """Dial (or reuse) the persistent connection.  Caller holds
        ``_conn_lock``."""
        if self._conn is not None and _peer_closed(self._conn):
            self._drop_conn()
        if self._conn is None:
            faultplan.check_connect(self.addr[0], self.addr[1])
            self._conn = socket.create_connection(self.addr, timeout=timeout)
        return self._conn

    def _drop_conn(self) -> None:
        """Close the connection (broken peer).  Caller holds
        ``_conn_lock``."""
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def rpc(self, req: dict, secret: bytes, timeout: float) -> dict:
        """One request/reply on the persistent connection."""
        with self._conn_lock:
            try:
                sock = self._connect(timeout)
                sock.settimeout(timeout)
                protocol.send_frame(sock, req, secret)
                return protocol.recv_frame(sock, secret)
            except (OSError, ConnectionError, protocol.ProtocolError):
                self._drop_conn()
                raise

    def close(self) -> None:
        # Deliberately NOT under _conn_lock: an inflight RPC holds that
        # lock for up to rpc_timeout, and close() is the call that must
        # CUT such an RPC — closing a socket from another thread
        # unblocks its pending recv (the RPC then fails onto the retry
        # ladder and drops the connection itself).  Waiting politely
        # here stalled daemon shutdown behind a blackholed worker.
        conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass


class WorkerPool:
    """Placement + dispatch across serve-capable distributor workers.

    Thread-safe: the dispatcher thread places, executor threads dispatch
    and release, ``close()`` may race both — all shared state (inflight
    depths, warm-key map, counters, the closed flag) mutates under one
    lock; per-worker sockets serialize under their own connection locks.
    """

    def __init__(
        self,
        workers,
        secret: bytes,
        spill_dir: str,
        max_inflight: int = 1,
        rpc_timeout: float = 600.0,
        spill_cap_bytes: int | None = None,
        epoch_fn=None,
    ):
        if not workers:
            raise ValueError("WorkerPool needs at least one worker address")
        if not secret:
            raise ValueError("WorkerPool requires the shared secret")
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.secret = secret
        self.spill_dir = spill_dir
        self.max_inflight = max_inflight
        self.rpc_timeout = rpc_timeout
        # Byte cap for a POOL-OWNED spill dir (the daemon passes one
        # when no journal owns the dir): without it a long-running
        # daemon's distinct-corpus stream grows the dir until the disk
        # fills — the journal-backed dir has compaction GC, this is the
        # ownerless dir's substitute.  None = someone else GCs.
        self.spill_cap_bytes = spill_cap_bytes
        # Fencing (docs/SERVING.md "High availability"): when set, every
        # serve_batch RPC is stamped with the daemon's promotion epoch
        # (protocol.EPOCH_KEY) so a worker that has served a newer
        # primary rejects a fenced-out zombie's dispatch structured.
        self.epoch_fn = epoch_fn
        self._spill_gc_lock = threading.Lock()
        self.workers = [
            PoolWorker(i, parse_worker_addr(w)) for i, w in enumerate(workers)
        ]
        os.makedirs(spill_dir, exist_ok=True)
        # Lazy: the serve package is pinned torch-free at import (a thin
        # control-plane client must never pay torch's import).  Only a
        # daemon that actually configured workers builds a pool.
        from locust_tpu_torch.distributor.master import WorkerHealth

        self.health = WorkerHealth(len(self.workers))
        self._lock = threading.Lock()
        self._inflight = [0] * len(self.workers)
        # affinity key -> worker idxs that hold it compiled.  A SET, not
        # one owner: repeat small jobs pack onto warm workers instead of
        # spraying cold compiles across the roster, but once several
        # workers are warm the load spreads across ALL of them — a
        # single-owner map was measured serializing the whole stream on
        # one worker's connection while its warm siblings idled.
        self._warm: dict[tuple, set[int]] = {}
        self._closed = False
        self._placements = [0] * len(self.workers)
        self._affinity_hits = 0
        self._spill_overs = 0
        self._place_fallbacks = 0
        self._dispatch_failures = 0
        # Dispatch executor: capacity-bounded — place() reserves a slot
        # before submit, so queued-but-unrunnable dispatches cannot pile
        # up.  Shut down (bounded) in close(), R012.
        self._executor = ThreadPoolExecutor(
            max_workers=len(self.workers) * max_inflight,
            thread_name_prefix="serve-pool",
        )

    # ---------------------------------------------------------- placement

    def capacity(self) -> int:
        return len(self.workers) * self.max_inflight

    def free_slots(self) -> int:
        """Open placement slots on PLACEABLE workers only: the dispatcher
        sizes its multi-batch pop by this, and counting quarantined
        workers' slots would pop batches that can only pile up
        serialized on the local floor."""
        with self._lock:
            if self._closed:
                return 0
            return sum(
                max(0, self.max_inflight - self._inflight[i])
                for i in range(len(self.workers))
                if self._placeable(i)
            )

    def preferred(self, key: tuple) -> tuple | None:
        """The warm workers for an affinity key (sorted name tuple, or
        None) — introspection for tests/operators; the placement
        decision itself lives in ``place()`` where load is known."""
        with self._lock:
            warm = self._warm.get(key)
            if not warm:
                return None
            return tuple(sorted(self.workers[i].name for i in warm))

    def _placeable(self, idx: int) -> bool:
        """Caller holds self._lock."""
        if self._inflight[idx] >= self.max_inflight:
            return False
        # Quarantined workers sit out their backoff; a due probe rides a
        # real dispatch (success un-quarantines), the master's stance.
        return not self.health.quarantined(idx)

    def place(self, key: tuple, exclude: set[int] | None = None):
        """Reserve a placement for one batch with affinity key ``key``.

        Returns the reserved ``PoolWorker`` (caller MUST ``release`` it)
        or None — the local-engine floor.  Policy: the warm (affine)
        worker when it has a free slot; otherwise the least-loaded
        placeable worker (spill-over); None when the pool is saturated,
        fully quarantined, closed, or the placement fault fires.
        """
        with obs.span("serve.place"):
            rule = faultplan.fire("serve.place", key=str(key))
            if rule is not None:
                if rule.action == "delay":
                    time.sleep(rule.delay_s)
                else:
                    # Placement failure: the batch falls back to the
                    # local engine — byte-identical, never an error the
                    # client sees.
                    with self._lock:
                        self._place_fallbacks += 1
                    return None
            with self._lock:
                if self._closed:
                    return None
                warm = self._warm.get(key) or ()
                candidates = [
                    i for i in range(len(self.workers))
                    if self._placeable(i)
                    and not (exclude and i in exclude)
                ]
                if not candidates:
                    self._place_fallbacks += 1
                    return None
                warm_cands = [i for i in candidates if i in warm]
                if warm_cands:
                    # Affinity: the least-loaded WARM worker — packs
                    # onto compiled executables without serializing the
                    # stream on a single warm worker while its warm
                    # siblings idle.  Ties by index for determinism.
                    idx = min(
                        warm_cands, key=lambda i: (self._inflight[i], i)
                    )
                    self._affinity_hits += 1
                    obs.metric_inc("serve.affinity_hits")
                else:
                    # Spill-over: every warm worker is saturated or
                    # quarantined — the queue must not block behind
                    # them, so the least-loaded cold candidate pays the
                    # compile.
                    idx = min(
                        candidates, key=lambda i: (self._inflight[i], i)
                    )
                    if warm:
                        self._spill_overs += 1
                self._inflight[idx] += 1
                self._placements[idx] += 1
                return self.workers[idx]

    def release(self, worker: PoolWorker) -> None:
        with self._lock:
            self._inflight[worker.idx] = max(
                0, self._inflight[worker.idx] - 1
            )

    def mark_warm(self, worker: PoolWorker, key: tuple) -> None:
        with self._lock:
            self._warm.setdefault(key, set()).add(worker.idx)

    # ----------------------------------------------------------- dispatch

    def submit(self, fn, *args):
        """Run ``fn`` on the pool's dispatch executor (the daemon's
        remote-dispatch path rides this so same-tick batches overlap)."""
        return self._executor.submit(fn, *args)

    def spill(self, sha: str, corpus: bytes) -> str:
        """Content-addressed write-once corpus spill (same layout as the
        journal's: ``<sha>.bin``, tmp + atomic rename).  Lock-free on
        purpose: a sha already on disk IS the bytes by construction and
        two concurrent writers race benignly through distinct tmp names
        into one atomic rename — holding the pool lock here would gate
        the whole placement plane on corpus disk I/O.  (GC coordination
        is the journal's own concern: pool spills always belong to LIVE
        jobs, which its compaction never sweeps.)"""
        path = os.path.join(self.spill_dir, f"{sha}.bin")
        if not os.path.exists(path):
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(corpus)
            os.replace(tmp, path)
            self._gc_spill()
        return path

    def _gc_spill(self) -> None:
        """Evict oldest spills past ``spill_cap_bytes`` (pool-owned dirs
        only).  Evicting a spill a dispatch is mid-reading is safe:
        the worker's sha check fails structured, and the retry re-spills
        from the daemon's still-buffered corpus bytes."""
        if self.spill_cap_bytes is None:
            return
        with self._spill_gc_lock:
            try:
                entries = []
                total = 0
                for name in os.listdir(self.spill_dir):
                    if not name.endswith(".bin"):
                        continue
                    p = os.path.join(self.spill_dir, name)
                    st = os.stat(p)
                    entries.append((st.st_mtime, st.st_size, p))
                    total += st.st_size
                entries.sort()
                for _mt, size, p in entries:
                    if total <= self.spill_cap_bytes:
                        break
                    os.remove(p)
                    total -= size
            except OSError:  # racing removals / dir vanishing at close
                pass

    def dispatch(
        self,
        worker: PoolWorker,
        workload: str,
        config: dict,
        bucket: int,
        jobs: list[dict],
        corpora: dict[str, bytes],
    ) -> dict:
        """One serve batch on ``worker``; returns the worker's reply —
        ``results`` holds per-job dicts (``job_id``/``pairs``/
        ``distinct``/``truncated``/``overflow_tokens``) in request
        order, ``warm`` whether the worker's executable was warm.

        Raises ``PoolDispatchError`` on ANY failure (dead worker,
        structured worker error, short reply) after marking the worker's
        health — the caller feeds the jobs back through the retry
        ladder.  A success clears the worker's quarantine slate.
        """
        for sha, data in corpora.items():
            self.spill(sha, data)
        req = {
            "cmd": "serve_batch",
            "workload": workload,
            "config": dict(config or {}),
            "bucket": int(bucket),
            "jobs": jobs,
            "spill_dir": self.spill_dir,
        }
        if self.epoch_fn is not None:
            req[protocol.EPOCH_KEY] = int(self.epoch_fn())
        try:
            reply = worker.rpc(req, self.secret, self.rpc_timeout)
        except Exception as e:
            self._dispatch_failed(
                worker,
                f"dispatch died ({type(e).__name__}: {e})",
                cause=e,
            )
        if reply.get("status") != "ok":
            self._dispatch_failed(
                worker, f"answered: {reply.get('error')}",
                code=reply.get("code"), epoch=reply.get("epoch"),
            )
        results = reply.get("results")
        if not isinstance(results, list) or len(results) != len(jobs):
            got = len(results) if isinstance(results, list) else 0
            self._dispatch_failed(
                worker, f"returned {got} results for {len(jobs)} jobs"
            )
        self.health.ok(worker.idx)
        return reply

    def stage_rpc(self, worker: PoolWorker, req: dict) -> dict:
        """One distributed-plan stage RPC on ``worker`` (docs/PLAN.md
        "Distributed execution"): the plan coordinator's map-split and
        reduce-partition dispatches ride this.  Epoch-stamped exactly
        like ``dispatch`` — a fenced-out zombie primary's stage can
        never publish a stale partition.  Raises ``PoolDispatchError``
        on ANY failure after marking the worker's health; a reduce
        stage's structured loss report surfaces as ``lost_split``."""
        req = dict(req, cmd="plan_stage")
        if self.epoch_fn is not None:
            req[protocol.EPOCH_KEY] = int(self.epoch_fn())
        try:
            reply = worker.rpc(req, self.secret, self.rpc_timeout)
        except Exception as e:
            self._dispatch_failed(
                worker,
                f"stage rpc died ({type(e).__name__}: {e})",
                cause=e,
            )
        if reply.get("status") != "ok":
            self._dispatch_failed(
                worker, f"answered: {reply.get('error')}",
                code=reply.get("code"), epoch=reply.get("epoch"),
                lost_split=reply.get("lost_split"),
                lost_epoch=reply.get("lost_epoch"),
            )
        self.health.ok(worker.idx)
        return reply

    def _dispatch_failed(
        self, worker: PoolWorker, msg: str, cause=None, code=None,
        epoch=None, lost_split=None, lost_epoch=None,
    ):
        """The ONE failure path out of ``dispatch``: quarantine the
        worker, count it, raise for the caller's retry ladder."""
        self.health.fail(worker.idx)
        with self._lock:
            self._dispatch_failures += 1
        err = PoolDispatchError(
            f"worker {worker.name} {msg}",
            code=str(code) if code else None,
            epoch=int(epoch) if epoch is not None else None,
            lost_split=int(lost_split) if lost_split is not None else None,
            lost_epoch=int(lost_epoch) if lost_epoch is not None else None,
        )
        if cause is not None:
            raise err from cause
        raise err

    def seed_affinity(self, worker: PoolWorker) -> int:
        """Warm-cache RPC: ask a worker which shapes it already holds
        compiled (``serve_stats``) and seed the affinity map — a daemon
        restarting against warm workers re-learns their homes instead of
        cold-spraying.  Best-effort with a SHORT timeout: this runs
        serially at daemon startup, and a roster of blackholed hosts
        must not hold the listen socket hostage for tens of seconds
        (affinity is re-learned from dispatches anyway)."""
        try:
            reply = worker.rpc(
                {"cmd": "serve_stats"}, self.secret, min(self.rpc_timeout, 2.0)
            )
        except Exception as e:  # noqa: BLE001 - seeding is best-effort
            logger.debug(
                "affinity seed from %s skipped (%s: %s); re-learned "
                "from dispatches", worker.name, type(e).__name__, e,
            )
            return 0
        shapes = reply.get("warm_shapes") or []
        n = 0
        with self._lock:
            for shape in shapes:
                try:
                    workload, fp, _njobs, bucket = shape
                except (TypeError, ValueError):
                    continue
                self._warm.setdefault(
                    ((str(workload), str(fp)), int(bucket)), set()
                ).add(worker.idx)
                n += 1
        return n

    # ------------------------------------------------------------ control

    def stats(self) -> dict:
        with self._lock:
            return {
                "workers": [w.name for w in self.workers],
                "inflight": list(self._inflight),
                "placements": list(self._placements),
                "affinity_hits": self._affinity_hits,
                "spill_overs": self._spill_overs,
                "local_fallbacks": self._place_fallbacks,
                "dispatch_failures": self._dispatch_failures,
                "quarantined": [
                    self.health.quarantined(i)
                    for i in range(len(self.workers))
                ],
                "warm_keys": len(self._warm),
            }

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop new placements and wait (bounded) for inflight worker
        RPCs to land.  True when the pool went quiet in time."""
        with self._lock:
            self._closed = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not any(self._inflight):
                    return True
            time.sleep(0.05)
        with self._lock:
            busy = sum(self._inflight)
        logger.warning(
            "serve pool still has %d inflight dispatch(es) after %.0fs "
            "drain; their jobs will fail structured at daemon close",
            busy, timeout,
        )
        return False

    def close(self, timeout: float = 30.0) -> None:
        """Drain (bounded), stop the executor, close every connection.
        Idempotent; safe to call with dispatches still inflight — they
        fail onto the retry ladder when their sockets close."""
        self.drain(timeout)
        # cancel_futures: anything still queued (there should be nothing,
        # place() reserved real slots) must not start after close.
        self._executor.shutdown(wait=False, cancel_futures=True)
        for w in self.workers:
            w.close()


def shard_ranges(n_lines: int, block_lines: int, shards: int) -> list[tuple[int, int]]:
    """Split ``n_lines`` into ``shards`` contiguous line ranges aligned
    to block boundaries (a shard is a whole number of blocks, so every
    shard's padding semantics match the engine's own block padding).
    Fewer ranges come back when the corpus has fewer blocks than
    requested shards."""
    n_blocks = max(1, -(-n_lines // block_lines))
    shards = max(1, min(shards, n_blocks))
    per = -(-n_blocks // shards)
    out = []
    start_blk = 0
    while start_blk < n_blocks:
        end_blk = min(n_blocks, start_blk + per)
        a = start_blk * block_lines
        b = min(n_lines, end_blk * block_lines)
        if b > a:
            out.append((a, b))
        start_blk = end_blk
    return out


def stable_shard_id(job_id: str, a: int, b: int) -> str:
    """Deterministic shard sub-id: replays and retries of the same job
    produce the same shard ids (chaos plans can target one shard)."""
    h = hashlib.sha256(f"{job_id}:{a}:{b}".encode()).hexdigest()[:6]
    return f"{job_id}#{a}-{b}-{h}"
