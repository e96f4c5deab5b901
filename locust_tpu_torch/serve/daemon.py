"""Locust Serve on the card: the persistent multi-tenant engine daemon.

The port of the JAX package's ``serve/daemon.py``.
The one-shot CLI pays process start on every run (torch's import and a
CUDA context are most of a small job's wall, PERF.md section 5); this
daemon keeps ONE process resident, with warm engines on the daemon's
device (docs/SERVING.md):

  * **protocol**: the distributor's authenticated length-prefixed frames
    (distributor/protocol.py — HMAC, replay guard), with the serve
    command set::

        submit | status | result | cancel | invalidate | stats
        | ping | shutdown

  * **admission + fairness**: a bounded queue that rejects-with-reason
    when full and a per-tenant weighted fair scheduler
    (serve/scheduler.py);
  * **warm-executable cache**: engines keyed by (workload, EngineConfig
    fingerprint, shape bucket) (serve/cache.py);
  * **shape-bucketed batching**: compatible queued jobs coalesce into one
    ``engine.run_batch`` dispatch and demultiplex per-job results
    (serve/batch.py); WordCount jobs fold through kernel B under
    ``sort_mode="bitonic"`` and kernel C under ``"fused"``/``"hasht"``;
  * **result cache** with explicit invalidation, persisted across
    restarts through the async snapshot writer (serve/cache.WarmState);
  * **durability**: the write-ahead job journal (serve/journal.py),
    replayed under the original job ids at restart; the retry ladder
    with bisection, poison quarantine and deadlines.

Device rule: ``ServeDaemon(device=None)`` resolves its device once, at
construction (CUDA unless the caller passes ``"cpu"``; no CUDA raises),
and on CUDA builds and loads the kernel libraries there, so a missing
card or a failed build is an error at start, never a stream of
``poison_job`` answers from a daemon that is up.  Only the dispatcher
thread touches the device, under ``_engine_lock``; handler threads parse,
admit, read caches and answer.  A failed kernel launch fails its jobs
through the retry ladder with a structured error; no job ever folds on
the CPU while the daemon's device is CUDA.

Scale-out (docs/SERVING.md): with ``workers`` the daemon places batches
on a pool of port (or JAX) ``--serve`` workers by cache affinity
(serve/pool.py), fans a job of ``shard_min_blocks`` blocks or more out as
line-range shards merged on the daemon's device, and runs covered plan
shapes (fold spines, join trees, PageRank) as stage waves over the pool
(plan/distribute.py); the local engine stays the floor.  High
availability: with ``ship_to`` the primary ships its write-ahead journal
to a hot standby (serve/replicate.py); with ``standby_of`` the daemon
starts as that standby and promotes on ``promote`` or when its lease
expires, replaying under the original job ids behind a fencing epoch.
The wire, the journal with its stage records, the epoch file and the
stats are the JAX daemon's, so the packages mix in one deployment.

Error discipline: a client observes either a correct result or a
STRUCTURED error carrying a ``jobs.ERROR_CODES`` reason — never a silent
wrong answer.  The ``serve.admit``, ``serve.dispatch`` and
``serve.journal`` fault sites (utils/faultplan.py) inject failures at
the admission, dispatch and journal boundaries.  Telemetry: per-job
phases land as ``serve.*`` spans (queue wait, compile-or-hit, dispatch,
demux) plus admission events and latency/cache metrics (obs/names.py).

torch-free at import: the engine, the plan compiler and io/snapshot load
when the daemon is constructed or first dispatches.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import logging
import os
import shutil
import socket
import tempfile
import threading
import time
import uuid

from locust_tpu_torch import obs
from locust_tpu_torch.distributor import protocol
from locust_tpu_torch.serve import batch as batching
from locust_tpu_torch.serve.cache import (
    ExecutableCache,
    ResultCache,
    SubPlanCache,
    WarmState,
)
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.serve.jobs import (
    WORKLOADS,
    Job,
    JobSpec,
    parse_spec,
    structured_error,
)
from locust_tpu_torch.serve.jobs import pairs_bytes as jobs_pairs_bytes
from locust_tpu_torch.plan import PlanError
from locust_tpu_torch.serve import replicate
from locust_tpu_torch.serve.journal import JobJournal
from locust_tpu_torch.serve.pool import PoolDispatchError
from locust_tpu_torch.serve.scheduler import AdmitReject, FairScheduler
from locust_tpu_torch.utils import faultplan

logger = logging.getLogger("locust_tpu_torch")

SERVE_COMMANDS = (
    "ping", "submit", "status", "result", "cancel", "invalidate",
    "stats", "shutdown",
    # High availability (docs/SERVING.md): "promote" flips a standby to
    # primary (fenced epoch bump + journal replay); the ship commands
    # are the primary->standby WAL replication stream
    # (serve/replicate.py; protocol.SHIP_COMMANDS).
    "promote", "ship", "ship_catchup", "ship_spill",
)

# Job-plane commands a STANDBY refuses with the structured not_primary
# code (naming the primary so roster clients redirect transparently).
# stats/ping/promote/ship* stay answerable — that is what "hot" means.
_PRIMARY_ONLY_COMMANDS = (
    "submit", "status", "result", "cancel", "invalidate",
)


class _PlanSolo(Exception):
    """Internal control flow for the plan coordinator: demote this plan
    job to the solo local engine, with a named reason.  Raised by the
    distributed path's safety gates (unrecognized shape raced in, too
    few placeable workers, a fold that would truncate where the solo
    evaluator's accounting differs) — the handler releases placements,
    counts ``plan_solo_fallbacks`` and runs the solo floor.  Never
    silent (docs/PLAN.md "Distributed execution")."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(reason)


@dataclasses.dataclass
class ServeConfig:
    """Daemon capacity/policy knobs: the JAX class's fields and defaults
    (docs/SERVING.md)."""

    max_queue: int = 64          # admission bound: pending jobs, global
    max_batch: int = 8           # jobs coalesced into one dispatch
    tenant_quota: int | None = 32  # pending jobs per tenant (None = off)
    max_engines: int = 4         # warm engines kept (LRU)
    max_results: int = 256       # result-cache entries kept (LRU)
    max_result_bytes: int = 256 << 20  # result-cache aggregate byte cap
    # Sub-plan (per-edge) result cache byte cap; entry count rides
    # max_results.
    max_subplan_bytes: int = 128 << 20
    # Aggregate cap on result payloads retained by FINISHED job records
    # (max_history bounds record COUNT).  Past it the oldest finished
    # records are evicted whole — a later fetch reads unknown_job.
    max_history_bytes: int = 256 << 20
    max_corpus_bytes: int = 16 << 20  # inline submit payload cap
    # Aggregate cap on ALL buffered in-flight corpora: overload must
    # become a structured rejection, not a dead daemon.
    max_queue_bytes: int = 256 << 20
    warm_dir: str | None = None  # persist warm state here (None = off)
    warm_every: int = 8          # warm-state generation cadence (jobs)
    max_history: int = 1024      # finished jobs kept for status/result
    conn_timeout: float = 30.0
    max_connections: int = 32
    dispatch_poll_s: float = 0.25  # dispatcher wake cadence when idle
    # Durability: with a journal_dir, every accepted job is fsync'd to
    # disk BEFORE its accept ack, and a restart replays unfinished jobs
    # under their original ids.
    journal_dir: str | None = None
    journal_fsync: bool = True       # False trades the kill -9 window for speed
    journal_compact_every: int = 512  # appends between journal compactions
    # Retry ladder: exponential backoff base/cap for failed dispatches;
    # attempts per job are bounded by the SPEC's max_attempts.
    retry_base_s: float = 0.2
    retry_cap_s: float = 5.0
    # Scale-out dispatch (docs/SERVING.md): place batches across a pool
    # of serve-capable distributor workers ("host:port" roster; empty =
    # every batch folds on the daemon's local engine, exactly the
    # pre-pool behavior).  The local engine stays the FLOOR: a saturated
    # or dead pool degrades to local dispatch, never to a dead daemon.
    workers: tuple = ()
    pool_inflight: int = 1           # concurrent batches per worker
    pool_rpc_timeout: float = 600.0  # bound on one worker dispatch RPC
    # Content-addressed corpus spill the pool workers read (<sha>.bin):
    # defaults to the journal's spill dir when journaling, else a
    # daemon-owned temp dir.  Workers must share this filesystem.
    pool_spill_dir: str | None = None
    # Large-job sharding: a job of >= shard_min_blocks blocks fans out
    # over up to shard_max workers (contiguous block-aligned line
    # ranges) and merges through the engine's combine; fewer than 2
    # placeable workers = the whole job folds locally.
    shard_min_blocks: int = 64
    shard_max: int = 4
    # Distributed plan execution (docs/PLAN.md "Distributed execution"):
    # a map/reduce stage attempt still unfinished this many seconds
    # after launch gets ONE speculative backup attempt on another held
    # worker — first finisher wins, the loser's partitions are ignored
    # (attempt-suffixed filenames keep them from colliding).
    plan_speculate_s: float = 30.0
    # High availability (docs/SERVING.md "High availability"): with
    # ship_to set ("host:port" of a hot standby) the primary ships
    # every fsync'd WAL record there asynchronously (serve/replicate.py)
    # — a dead standby degrades to a logged warning + lag gauge, never a
    # slow admit.  With standby_of set ("host:port" of the primary, the
    # address not_primary rejections name until ship traffic refines
    # it) the daemon starts as a WARM STANDBY: it applies shipped
    # records into its own journal, answers stats/ping only, and
    # refuses the job plane until promoted — by the explicit `promote`
    # command, or automatically when lease_s passes with no primary
    # contact (None = manual promotion only).  Both require journal_dir
    # (the WAL is what ships).
    ship_to: str | None = None
    standby_of: str | None = None
    lease_s: float | None = None
    ship_heartbeat_s: float = 2.0


class ServeDaemon:
    """One serve daemon: accept loop + single dispatcher thread.

    Folds serialize through the ONE dispatcher (the node has one card);
    handler threads only touch the queue, the caches, and job records.
    ``device`` is the engines' device: None = CUDA (raises without one),
    ``"cpu"`` the plain versions of the kernels.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        secret: bytes = b"",
        cfg: ServeConfig | None = None,
        device=None,
    ):
        if not secret:
            raise ValueError("serve daemon requires a shared secret "
                             "(same Q8 stance as the distributor)")
        cfg = cfg or ServeConfig()
        if (cfg.ship_to or cfg.standby_of) and not cfg.journal_dir:
            # Both sides of an HA pair need the WAL: it is the thing
            # that ships.  Refused before the device and the kernels.
            raise ValueError(
                "--ship-to / --standby-of require --journal-dir: the "
                "write-ahead journal is what replication ships"
            )
        from locust_tpu_torch.engine import resolve_device

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # Build and load every kernel library now: a failed nvcc
            # build found at the first dispatch would become a stream of
            # poison_job answers from a daemon that is up.
            from locust_tpu_torch import _build

            _build.build()
            for name in _build.KERNEL_SOURCES:
                _build.load(name)
        self.secret = secret
        self.cfg = cfg
        self.scheduler = FairScheduler(
            max_queue=self.cfg.max_queue,
            max_batch=self.cfg.max_batch,
            tenant_quota=self.cfg.tenant_quota,
        )
        self.executables = ExecutableCache(
            max_engines=self.cfg.max_engines, device=self.device
        )
        self.results = ResultCache(
            max_entries=self.cfg.max_results,
            max_bytes=self.cfg.max_result_bytes,
        )
        # Per-edge fold results for plan jobs (plan/compile.py _RunCtx).
        # In-memory only: WAL replay recomputes from cold, identically.
        self.subplans = SubPlanCache(
            max_entries=self.cfg.max_results,
            max_bytes=self.cfg.max_subplan_bytes,
        )
        self.warm = (
            WarmState(self.cfg.warm_dir, self.results)
            if self.cfg.warm_dir
            else None
        )
        if self.warm is not None:
            self.warm.load()
        self.journal = (
            JobJournal(
                self.cfg.journal_dir,
                fsync=self.cfg.journal_fsync,
                compact_every=self.cfg.journal_compact_every,
            )
            if self.cfg.journal_dir
            else None
        )
        # High availability (docs/SERVING.md): roles, fencing epoch, and
        # the replication endpoints (both sides need the WAL, checked
        # above).
        self.role = "standby" if self.cfg.standby_of else "primary"
        self.epoch = (
            replicate.load_epoch(self.cfg.journal_dir)
            if self.journal is not None else 1
        )
        self._seen_epoch = self.epoch   # highest epoch observed anywhere
        self._primary_hint = self.cfg.standby_of  # who not_primary names
        self._fenced_by: int | None = None  # epoch that demoted us, if any
        self._promote_lock = threading.Lock()  # serializes role flips
        self.receiver = (
            replicate.ShipReceiver(self.journal)
            if self.journal is not None else None
        )
        if self.receiver is not None:
            self.receiver.touch()  # the lease clock starts now
        self.shipper = None
        self.pool = None
        self._pool_spill_owned: str | None = None
        if self.cfg.workers:
            from locust_tpu_torch.serve.pool import WorkerPool

            spill_dir = self.cfg.pool_spill_dir
            if spill_dir is None and self.journal is not None:
                # Share the journal's content-addressed spill: admitted
                # corpora are already on disk there, so pool dispatches
                # re-serialize nothing.
                spill_dir = self.journal.corpus_dir
            if spill_dir is None:
                spill_dir = tempfile.mkdtemp(prefix="locust-serve-pool-")
                self._pool_spill_owned = spill_dir
            self.pool = WorkerPool(
                self.cfg.workers,
                secret,
                spill_dir=spill_dir,
                max_inflight=self.cfg.pool_inflight,
                rpc_timeout=self.cfg.pool_rpc_timeout,
                # Fencing: every serve_batch RPC carries this daemon's
                # promotion epoch; a worker that has seen a newer
                # primary answers structured stale_epoch and the zombie
                # demotes instead of split-braining (docs/SERVING.md).
                epoch_fn=lambda: self.epoch,
                # A pool-owned dir has no journal compaction behind it:
                # cap it so a long-running distinct-corpus stream cannot
                # fill the disk (evicted spills re-spill on retry).
                spill_cap_bytes=(
                    2 * self.cfg.max_queue_bytes
                    if self._pool_spill_owned else None
                ),
            )
            # Warm-cache RPC: re-learn which worker already holds which
            # compiled shapes (a daemon restart against a warm fleet
            # must not cold-spray its first batches).  Best-effort.
            for w in self.pool.workers:
                self.pool.seed_affinity(w)
            # Shard coordinators run OFF the dispatcher thread: a
            # coordinator blocks (bounded) on its shard futures, and
            # parking the single dispatcher there would stall every
            # other tenant's dispatch and the deadline sweep for up to
            # pool_rpc_timeout.  Dedicated and small on purpose —
            # coordinators submit shard RPCs to the POOL executor, so
            # sharing that executor could deadlock with every thread a
            # waiting coordinator.
            self._shard_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="serve-shard"
            )
        self._lock = threading.Lock()
        # The node has ONE card: every device touch — engine builds,
        # staging, folds and the demux's device->host reads — runs on
        # the dispatcher thread under this lock.
        self._engine_lock = threading.Lock()
        self._jobs: dict[str, Job] = {}       # insertion order = age
        # Distributed-plan coordinator state (docs/PLAN.md "Distributed
        # execution"), both under self._lock: stage/recompute counters
        # surfaced in the stats "pool" sub-dict, and WAL-replayed stage
        # progress (job_id -> completed map-split records) so a restart
        # reuses surviving shuffle partitions instead of remapping.
        self._plan_counters = {
            "stages": 0, "recomputes": 0,
            "speculated": 0, "partitions_reused": 0,
            # Satellite of the plan-surface-v2 round: a pool-eligible
            # plan job demoted to the solo engine is NEVER silent (the
            # fused_demoted stance) — counted here, logged once per
            # reason (_count_plan_solo).
            "plan_solo_fallbacks": 0,
            # Distributed map splits that landed on a worker's warm
            # fold-node executable (cache.fold_node_key): a repeat
            # distributed plan should push this up while the workers'
            # ``compiles`` stay flat.
            "map_warm_hits": 0,
        }
        self._plan_solo_logged: set[str] = set()
        self._plan_progress: dict[str, list] = {}
        self._corpus_bytes: dict[str, bytes] = {}  # job_id -> in-flight bytes
        self._corpus_total = 0  # sum of _corpus_bytes values (admission cap)
        self._result_bytes = 0  # sum of retained job.result_bytes (history cap)
        self._completed = 0
        self._warm_marked = 0  # completed-count at the last warm mark
        self._started_s = time.monotonic()
        self._replay_guard = protocol.ReplayGuard()
        self._conn_slots = threading.BoundedSemaphore(self.cfg.max_connections)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(5)
        self.addr = self._sock.getsockname()
        self._shutdown = threading.Event()
        self._closed = False
        # Replay BEFORE the dispatcher exists: re-enqueued jobs must be
        # fully staged (record + corpus) before anything can pop them —
        # the same record-before-admit ordering the submit path keeps.
        # A STANDBY deliberately skips replay: its journal mirrors the
        # primary's live set via shipping, and promotion is the moment
        # replay (and dispatch) begins.
        if self.journal is not None and self.role == "primary":
            self._replay_journal()
        if self.cfg.ship_to and self.role == "primary":
            self._start_shipper()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatch", daemon=True
        )
        self._dispatcher.start()

    def _start_shipper(self) -> None:
        """Wire the async WAL shipper to the standby (primary role only;
        replay has already run, so the first catch-up snapshot carries
        exactly the live set)."""
        from locust_tpu_torch.serve.pool import parse_worker_addr

        self.shipper = replicate.ReplicationShipper(
            parse_worker_addr(self.cfg.ship_to),
            self.secret,
            self.journal,
            epoch_fn=lambda: self.epoch,
            advertise=f"{self.addr[0]}:{self.addr[1]}",
            on_fenced=self._demote,
            heartbeat_s=self.cfg.ship_heartbeat_s,
        )
        self.journal.on_append = self.shipper.enqueue
        self.shipper.start()

    # --------------------------------------------------------- accept loop

    def serve_forever(self) -> None:
        # try/finally, not loop-exit cleanup: a KeyboardInterrupt in the
        # foreground CLI lands inside accept() and would otherwise skip
        # close() — losing the final warm-state flush the --warm-dir
        # flag promises (close() is idempotent, so the shutdown-command
        # path calling through here again is safe).
        try:
            while not self._shutdown.is_set():
                try:
                    self._sock.settimeout(0.5)
                    conn, _peer = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                # Bounded acquire: a plain acquire() with all slots held
                # by slow peers would wedge this loop PAST the shutdown
                # check — neither a shutdown command nor close() could
                # ever land.
                acquired = False
                while not self._shutdown.is_set():
                    if self._conn_slots.acquire(timeout=0.5):
                        acquired = True
                        break
                if not acquired:
                    conn.close()
                    continue
                threading.Thread(
                    target=self._serve_one, args=(conn,), daemon=True
                ).start()
        finally:
            self._sock.close()
            self.close()

    def serve_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def close(self) -> None:
        """Stop the dispatcher and flush warm state.  Idempotent and
        race-safe: the accept loop's exit path and an operator teardown
        may both call it (first caller wins the warm flush)."""
        self._shutdown.set()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            gen = self._completed
        self.scheduler.stop()
        # Local snapshot: a concurrent fenced _demote() nulls the
        # attribute, and `if self.shipper ...: self.shipper.stop()`
        # would re-read it after the check.
        shipper = self.shipper
        if shipper is not None:
            # Before the dispatcher join: the shipper only reads the
            # journal and its own queue, and stopping it first means the
            # final terminal records below are the last thing it could
            # have shipped anyway (the standby's replay recomputes
            # whatever a lost flush-only record would have said).
            shipper.stop()
        # The join must outlive one cold dispatch (an engine's first
        # fold at a new shape): a shorter timeout lets close() flush +
        # close the warm writer while a dispatch is mid-flight, so that
        # batch's late warm.mark hits a closed writer.
        self._dispatcher.join(timeout=90.0)
        if self._dispatcher.is_alive():
            logger.warning(
                "serve dispatcher still busy after 90s at close; jobs "
                "finishing after this point will not reach warm state"
            )
        if self.pool is not None:
            # Pool teardown ordering (docs/SERVING.md): stop placements
            # and join inflight worker RPCs (bounded) BEFORE the
            # stranded-job drain and the warm flush — a remote batch
            # landing during the drain still publishes its results, and
            # a batch that dies with its worker requeues onto the
            # stopped scheduler, fails structured shutting_down below.
            self.pool.close(timeout=30.0)
            # After the pool's sockets close, any coordinator still
            # waiting sees its shard futures fail fast and routes its
            # job through the stopped scheduler to a structured
            # shutting_down — nothing left is worth blocking on.
            self._shard_executor.shutdown(wait=False, cancel_futures=True)
            if self._pool_spill_owned:
                shutil.rmtree(self._pool_spill_owned, ignore_errors=True)
        # The stopped scheduler answers next_batch with None forever, so
        # jobs still queued here can never dispatch: fail them with the
        # structured shutdown code and free their buffered corpora — an
        # accepted job must end in a result or a reason code.
        stranded = self.scheduler.drain()
        if stranded:
            with self._lock:
                for job in stranded:
                    self._corpus_pop(job.job_id)
            self._fail_batch(stranded, structured_error(
                "shutting_down",
                "daemon shut down before this job was dispatched; "
                "resubmit after it returns",
            ))
        if self.warm is not None:
            try:
                self.warm.mark(gen + 1)  # final generation: latest results
            except Exception:  # noqa: BLE001 - a failed PRIOR background
                # write re-raises at the next submit (io/snapshot.py);
                # the flush is best-effort at shutdown and must not
                # leave the writer thread unjoined.
                logger.exception("serve final warm mark failed")
            self.warm.close()
        if self.journal is not None:
            # Clean shutdown leaves a compact journal: stranded jobs were
            # just failed structured above, so nothing is live.
            try:
                self._compact_journal()
            except Exception:  # noqa: BLE001 - best-effort at teardown
                logger.exception("serve journal compaction failed at close")
            self.journal.close()

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            self._serve_conn(conn)
        finally:
            self._conn_slots.release()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                while not self._shutdown.is_set():
                    try:
                        conn.settimeout(self.cfg.conn_timeout)
                        req = protocol.recv_frame(conn, self.secret)
                    except PermissionError:
                        return  # unauthenticated peer: drop silently
                    except (ConnectionError, socket.timeout, OSError):
                        return  # peer closed / idled out
                    except Exception as e:
                        self._try_reply(
                            conn, structured_error("bad_spec", str(e))
                        )
                        return
                    try:
                        self._replay_guard.check(req)
                        resp = self._handle(req)
                    except PermissionError:
                        return  # replayed frame: drop silently
                    except Exception as e:  # noqa: BLE001 - daemon survives
                        resp = structured_error(
                            "dispatch_failed", f"{type(e).__name__}: {e}"
                        )
                    if not self._try_reply(conn, resp):
                        return
        except Exception:  # noqa: BLE001 - connection threads never die loud
            logger.exception("serve connection handler failed")

    def _try_reply(self, conn: socket.socket, resp: dict) -> bool:
        try:
            protocol.send_frame(conn, resp, self.secret, sign_fresh=False)
            return True
        except protocol.FrameTooLarge as e:
            # Raised BEFORE any bytes hit the wire (send_frame sizes the
            # whole frame first), so the connection is still clean:
            # answer with a small structured error instead of dropping
            # the peer — a completed job whose result JSON exceeds
            # MAX_FRAME would otherwise be permanently unfetchable
            # through bare ConnectionErrors, against the tier's
            # correct-result-or-structured-error guarantee.
            err = structured_error(
                "result_too_large",
                f"reply frame exceeds protocol.MAX_FRAME "
                f"({protocol.MAX_FRAME} bytes): {e}; lower table_size "
                "or split the corpus",
            )
            try:
                protocol.send_frame(
                    conn, err, self.secret, sign_fresh=False
                )
                return True
            except (protocol.ProtocolError, OSError):
                return False
        except OSError:
            return False

    # ----------------------------------------------------------- commands

    def _handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd not in SERVE_COMMANDS:
            return structured_error(
                "unknown_command",
                f"unknown command {cmd!r} (serve speaks {SERVE_COMMANDS})",
            )
        if cmd == "ping":
            return {"status": "ok", "pong": True, "service": "locust-serve"}
        if cmd == "shutdown":
            self._shutdown.set()
            return {"status": "ok", "bye": True}
        if cmd == "promote":
            return self._cmd_promote()
        if cmd in protocol.SHIP_COMMANDS:
            return self._cmd_ship(cmd, req)
        if cmd in _PRIMARY_ONLY_COMMANDS:
            not_primary = self._not_primary_reply()
            if not_primary is not None:
                return not_primary
        if cmd == "submit":
            return self._cmd_submit(req)
        if cmd == "status":
            return self._cmd_status(req)
        if cmd == "result":
            return self._cmd_result(req)
        if cmd == "cancel":
            return self._cmd_cancel(req)
        if cmd == "invalidate":
            return self._cmd_invalidate(req)
        return self._cmd_stats()

    def _cmd_submit(self, req: dict) -> dict:
        try:
            spec, corpus = parse_spec(
                req, max_corpus_bytes=self.cfg.max_corpus_bytes
            )
        except ValueError as e:
            code, _, msg = str(e).partition("\n")
            obs.event("serve.reject", code=code)
            return structured_error(code, msg or code)
        if len(corpus) > self.cfg.max_corpus_bytes:
            obs.event("serve.reject", code="corpus_too_large")
            return structured_error(
                "corpus_too_large",
                f"inline corpus of {len(corpus)} bytes exceeds the "
                f"daemon cap ({self.cfg.max_corpus_bytes}); stream it "
                "through a server-side path instead",
            )
        # Chaos: the admission boundary (docs/FAULTS.md).  "error" models
        # an admission subsystem failure — the client gets a structured
        # rejection and may retry; "delay" models admission contention.
        rule = faultplan.fire(
            "serve.admit", tenant=spec.tenant, workload=spec.workload
        )
        if rule is not None:
            if rule.action == "delay":
                time.sleep(rule.delay_s)
            else:
                obs.event("serve.reject", code="fault_injected")
                return structured_error(
                    "fault_injected",
                    "[faultplan] injected admission failure — retry",
                )
        digest = hashlib.sha256(corpus).hexdigest()
        spec_fp = spec.fingerprint()
        n_lines = batching.count_lines(corpus)
        n_blocks, bucket = batching.job_shape(n_lines, spec.cfg)
        job = Job(
            job_id=uuid.uuid4().hex[:12],
            spec=spec,
            corpus_digest=digest,
            n_lines=n_lines,
            n_blocks=n_blocks,
            bucket=bucket,
            config_overrides=dict(req.get("config") or {}),
        )
        if not spec.no_cache and not spec.invalidate:
            hit = self.results.get_with_meta(digest, spec_fp)
            if hit is not None:
                # Served straight from the result cache: no queue, no
                # engine.  The job record still exists so status/result
                # work uniformly.  The ORIGINAL run's truncation flags
                # replay with the pairs — a lossy result must stay
                # flagged lossy on every replay, or the cache hit would
                # be the silent wrong answer this tier forbids.
                pairs, meta = hit
                job.state = "done"
                job.cache = "result"
                job.started_s = job.submitted_s
                job.finished_s = time.monotonic()
                job.result = pairs
                job.result_bytes = jobs_pairs_bytes(pairs)
                job.distinct = int(meta.get("distinct", len(pairs)))
                job.truncated = bool(meta.get("truncated", False))
                job.overflow_tokens = int(meta.get("overflow_tokens", 0))
                with self._lock:
                    self._result_bytes += job.result_bytes
                    self._remember(job)
                    self._completed += 1
                obs.metric_inc("serve.result_cache_hits")
                obs.metric_inc("serve.jobs")
                obs.metric_observe("serve.latency_ms", job.latency_ms())
                return {
                    "status": "ok", "job_id": job.job_id,
                    "state": "done", "cached": True,
                }
        # Record the job + its bytes BEFORE admit: admit() wakes the
        # dispatcher, which may pop the job immediately — if the corpus
        # landed after, the dispatch would fold an empty stack and hand
        # the client a silently-empty "done" (the exact wrong answer
        # this tier promises never to produce).
        with self._lock:
            over = (
                self._corpus_total + len(corpus)
                > self.cfg.max_queue_bytes
            )
            if not over:
                self._remember(job)
                self._corpus_put(job.job_id, corpus)
        if over:
            self.scheduler.count_rejection()
            obs.event("serve.reject", code="queue_full")
            return structured_error(
                "queue_full",
                f"buffered corpus bytes at cap "
                f"({self.cfg.max_queue_bytes}); retry with backoff",
            )
        # Write-ahead append BEFORE the scheduler sees the job and BEFORE
        # the ack leaves: the record is what makes the ack a durable
        # promise (docs/SERVING.md).  An append that fails must become a
        # structured rejection — acking unjournaled work would silently
        # demote the durability guarantee.
        if self.journal is not None:
            try:
                self.journal.append_admit(job, corpus)
            except faultplan.FaultInjected:
                with self._lock:
                    self._jobs.pop(job.job_id, None)
                    self._corpus_pop(job.job_id)
                obs.event("serve.reject", code="fault_injected")
                return structured_error(
                    "fault_injected",
                    "[faultplan] injected journal crash at append — "
                    "the job was never acked; retry",
                )
            except Exception as e:  # noqa: BLE001 - disk full/permission
                logger.exception("serve journal append failed")
                with self._lock:
                    self._jobs.pop(job.job_id, None)
                    self._corpus_pop(job.job_id)
                obs.event("serve.reject", code="journal_failed")
                return structured_error(
                    "journal_failed",
                    f"write-ahead journal append failed "
                    f"({type(e).__name__}: {e}); the accept ack would "
                    "not be durable — fix the journal volume and retry",
                )
        try:
            self.scheduler.admit(job)
        except AdmitReject as e:
            with self._lock:
                self._jobs.pop(job.job_id, None)
                self._corpus_pop(job.job_id)
            if self.journal is not None:
                # Tombstone so replay cannot resurrect a job the client
                # was told is NOT in the system.
                self.journal.append_state(job.job_id, "rejected")
            obs.event("serve.reject", code=e.code)
            return structured_error(e.code, str(e))
        if spec.invalidate:
            # Only AFTER admission succeeds: a rejected submit must have
            # no side effects — wiping before admission let one tenant's
            # queue_full request destroy the cached entry every other
            # tenant was being served from.  (The cache-hit check above
            # already skips lookups for invalidate submits, so this job
            # recomputes either way.)
            self.results.invalidate(digest=digest, spec_fp=spec_fp)
            # A fresh-recompute request must not be answered from the
            # per-edge cache either (same post-admission discipline).
            self.subplans.invalidate(corpus_sha=digest)
        obs.event(
            "serve.admit",
            job=job.job_id, tenant=spec.tenant, bucket=bucket,
        )
        return {
            "status": "ok", "job_id": job.job_id,
            "state": "queued", "cached": False,
        }

    def _remember(self, job: Job) -> None:
        """Record a job, then evict past the history caps.  Caller
        holds self._lock."""
        self._jobs[job.job_id] = job
        self._evict_history(keep=job.job_id)

    def _evict_history(self, keep: str | None = None) -> None:
        """Evict the OLDEST FINISHED records while over the history
        count cap OR the aggregate retained-result byte cap
        (queued/running records are live state, never evicted).
        ``keep`` is the job whose completion triggered this call: it
        must survive even when its result alone overflows the byte cap,
        or a job could be evicted between its own done-ack and the
        client's result fetch (same stance as ResultCache keeping a
        single oversized entry).  Caller holds self._lock."""

        def over() -> bool:
            return (len(self._jobs) > self.cfg.max_history
                    or self._result_bytes > self.cfg.max_history_bytes)

        if not over():
            return
        for jid, j in list(self._jobs.items()):
            if not over():
                break
            if jid != keep and j.state in ("done", "failed", "cancelled"):
                del self._jobs[jid]
                self._corpus_pop(jid)
                self._result_bytes -= j.result_bytes

    def _job(self, req: dict) -> Job | None:
        with self._lock:
            return self._jobs.get(str(req.get("job_id", "")))

    def _corpus_put(self, job_id: str, data: bytes) -> None:
        """Buffer one job's corpus; caller holds self._lock."""
        self._corpus_bytes[job_id] = data
        self._corpus_total += len(data)

    def _corpus_pop(self, job_id: str) -> bytes | None:
        """Drop one job's buffered corpus; caller holds self._lock."""
        data = self._corpus_bytes.pop(job_id, None)
        if data is not None:
            self._corpus_total -= len(data)
        return data

    def _cmd_status(self, req: dict) -> dict:
        job = self._job(req)
        if job is None:
            return structured_error(
                "unknown_job", f"no job {req.get('job_id')!r}"
            )
        return {"status": "ok", **job.public()}

    def _cmd_result(self, req: dict) -> dict:
        job = self._job(req)
        if job is None:
            return structured_error(
                "unknown_job", f"no job {req.get('job_id')!r}"
            )
        if job.state == "failed":
            err = job.error or structured_error(
                "dispatch_failed", "job failed"
            )
            return dict(err, job_id=job.job_id, state="failed")
        if job.state == "cancelled":
            return structured_error(
                "cancelled", f"job {job.job_id} was cancelled"
            )
        if job.state != "done":
            return dict(
                structured_error(
                    "not_done", f"job {job.job_id} is {job.state}"
                ),
                state=job.state,
            )
        return {
            "status": "ok",
            "job_id": job.job_id,
            "state": "done",
            "cache": job.cache,
            # Plan results are ONE (rendered-output-bytes, 0) pair; the
            # flag tells clients to print the key raw instead of as a
            # key<TAB>count table (docs/PLAN.md).
            "plan": job.spec.plan is not None,
            "distinct": job.distinct,
            "truncated": job.truncated,
            "overflow_tokens": job.overflow_tokens,
            "latency_ms": job.latency_ms(),
            "pairs": [
                [base64.b64encode(k).decode(), int(v)]
                for k, v in (job.result or [])
            ],
        }

    def _cmd_cancel(self, req: dict) -> dict:
        job = self._job(req)
        if job is None:
            return structured_error(
                "unknown_job", f"no job {req.get('job_id')!r}"
            )
        popped = self.scheduler.cancel(job.job_id)
        if popped is not None:
            with self._lock:
                job.state = "cancelled"
                job.finished_s = time.monotonic()
                job.error = structured_error(
                    "cancelled", "cancelled while queued"
                )
                self._corpus_pop(job.job_id)
            if self.journal is not None:
                # The error payload rides the record: replay restores the
                # job's structured code as "cancelled", not a generic
                # failure a client's .code switch would mishandle.
                self.journal.append_state(
                    job.job_id, "cancelled", error=job.error
                )
            return {"status": "ok", "cancelled": True, "state": "cancelled"}
        # Running/finished jobs are past the point of no return — report
        # the state, don't pretend.
        return {"status": "ok", "cancelled": False, "state": job.state}

    def _cmd_invalidate(self, req: dict) -> dict:
        digest = req.get("digest")
        spec_fp = req.get("spec_fp")
        if req.get("job_id"):
            job = self._job(req)
            if job is None:
                # Falling through with (digest, spec_fp) both None hits
                # ResultCache's wipe-everything match: a typo'd or
                # history-evicted id would silently destroy EVERY
                # tenant's cached results and still answer "ok".
                return structured_error(
                    "unknown_job", f"no job {req.get('job_id')!r}"
                )
            digest = job.corpus_digest
            spec_fp = job.spec.fingerprint()
        n = self.results.invalidate(
            digest=str(digest) if digest else None,
            spec_fp=str(spec_fp) if spec_fp else None,
        )
        # Per-edge entries for the same corpus go too (a spec_fp-only
        # invalidation keeps them: closure fingerprints are shared
        # across specs, and other tenants' edges stay warm).
        if digest or not spec_fp:
            n += self.subplans.invalidate(
                corpus_sha=str(digest) if digest else None
            )
        return {"status": "ok", "invalidated": n}

    def _cmd_stats(self) -> dict:
        with self._lock:
            states: dict[str, int] = {}
            for j in self._jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
            completed = self._completed
            corpus_total = self._corpus_total
            result_bytes = self._result_bytes
            plan_counters = dict(self._plan_counters)
        return {
            "status": "ok",
            "service": "locust-serve",
            "uptime_s": round(time.monotonic() - self._started_s, 3),
            "completed": completed,
            "jobs_by_state": states,
            "queued_corpus_bytes": corpus_total,
            "history_result_bytes": result_bytes,
            "queue": self.scheduler.stats(),
            # The pool sub-dict carries the distributed-plan coordinator
            # counters (stage RPCs run, recomputes, speculative backups,
            # WAL-replay partition reuse — docs/PLAN.md).
            "pool": (
                dict(self.pool.stats(), plan=plan_counters)
                if self.pool is not None else None
            ),
            "exec_cache": self.executables.stats(),
            "result_cache": self.results.stats(),
            "subplan_cache": self.subplans.stats(),
            "warm": self.warm.stats() if self.warm is not None else None,
            "journal": (
                self.journal.stats() if self.journal is not None else None
            ),
            # HA operator surface (docs/SERVING.md "High availability"):
            # role, fencing epoch, shipping lag / standby application
            # state — readable without touching logs.
            "replication": self._replication_stats(),
        }

    # ---------------------------------------------------- high availability

    def _not_primary_reply(self) -> dict | None:
        """The structured standby refusal for job-plane commands, naming
        the primary so roster clients redirect transparently — or None
        when this daemon IS the primary."""
        with self._lock:
            if self.role == "primary":
                return None
            primary = self._primary_hint
        if self.receiver is not None:
            # Ship traffic carries the primary's advertised address —
            # fresher than any static seed after a chain of failovers.
            primary = self.receiver.primary() or primary
        reply = structured_error(
            "not_primary",
            f"this daemon is a standby; submit to the primary"
            + (f" at {primary}" if primary else ""),
        )
        if primary:
            reply["primary"] = primary
        return reply

    def _cmd_promote(self) -> dict:
        """Operator-driven takeover.  Refused on a daemon that is
        already primary (the double-promotion guard): promoting twice —
        or promoting the live primary by mistake — must be a loud no,
        not a silent epoch bump that fences a healthy peer."""
        with self._lock:
            already = self.role == "primary"
            epoch = self.epoch
        if already:
            return structured_error(
                "bad_spec",
                f"promote refused: this daemon is already the primary "
                f"(epoch {epoch})",
            )
        self._promote(reason="command")
        with self._lock:
            return {"status": "ok", "role": self.role, "epoch": self.epoch}

    def _cmd_ship(self, cmd: str, req: dict) -> dict:
        """Route one replication frame (docs/SERVING.md): fence first,
        then apply.  A primary receiving a VALID (>= epoch) ship has
        been superseded — it demotes and applies, the split-brain
        resolution arm of the fencing protocol."""
        if self.receiver is None:
            return structured_error(
                "bad_spec",
                "this daemon has no journal; start it with --journal-dir "
                "to receive replication",
            )
        incoming = int(req.get(protocol.EPOCH_KEY) or 0)
        with self._lock:
            epoch = self.epoch
            role = self.role
            self._seen_epoch = max(self._seen_epoch, incoming)
        if incoming < epoch:
            # The zombie-primary fence: an old epoch's ship is rejected
            # structured, and the reply names US as the address to
            # follow — the zombie demotes instead of split-braining.
            return replicate.stale_reply(
                epoch, f"{self.addr[0]}:{self.addr[1]}"
                if role == "primary" else self._primary_hint,
            )
        if role == "primary":
            if incoming > epoch:
                # A genuinely newer primary: we are the zombie.
                self._demote(incoming, req.get("from"))
            else:
                # EQUAL epochs: two daemons both believe they are
                # primary (a misconfigured ring, or a partition healing
                # before any promotion).  Deterministic tie-break — the
                # lexicographically smaller advertised address keeps
                # primaryship — so exactly ONE side demotes; without it
                # a mutual first-ship race demotes both and the pair
                # deadlocks with no primary at all.
                mine = f"{self.addr[0]}:{self.addr[1]}"
                sender = str(req.get("from") or "")
                if sender and sender < mine:
                    self._demote(incoming, sender)
                else:
                    return replicate.stale_reply(epoch, mine)
        # Apply under the promotion lock: a promote() that lands while
        # this frame is in flight bumps the epoch first, so re-checking
        # here keeps a just-promoted daemon from applying a stale ship
        # concurrently with its own replay.
        with self._promote_lock:
            with self._lock:
                if incoming < self.epoch:
                    return replicate.stale_reply(
                        self.epoch, f"{self.addr[0]}:{self.addr[1]}"
                        if self.role == "primary" else self._primary_hint,
                    )
            if cmd == "ship":
                return self.receiver.handle_ship(req)
            if cmd == "ship_catchup":
                return self.receiver.handle_catchup(req)
            return self.receiver.handle_spill(req)

    def _promote(self, reason: str) -> None:
        """Fenced takeover: bump + persist the epoch past everything
        ever observed, become primary, then replay the replicated
        journal exactly like PR 9's restart path — unfinished jobs
        re-enqueue under their ORIGINAL ids and recompute
        byte-identically.  Serialized against demotion and concurrent
        promotes; ship frames arriving after the flip carry the old
        epoch and bounce off the fence."""
        with self._promote_lock:
            with self._lock:
                if self.role == "primary":
                    return
                self.epoch = max(self.epoch, self._seen_epoch) + 1
                self._seen_epoch = self.epoch
                self.role = "primary"
                self._fenced_by = None
                epoch = self.epoch
            replicate.store_epoch(self.cfg.journal_dir, epoch)
            obs.event("serve.takeover", role="primary", epoch=epoch,
                      reason=reason)
            logger.warning(
                "serve daemon promoted to PRIMARY (epoch %d, %s); "
                "replaying the replicated journal", epoch, reason,
            )
            self._replay_journal()
            if self.cfg.ship_to and self.shipper is None:
                # Symmetric pair: a promoted standby configured with
                # --ship-to starts replicating BACK, so the demoted old
                # primary becomes the new hot standby (ring failover).
                self._start_shipper()

    def _demote(self, higher_epoch: int, primary=None) -> None:
        """A newer primary exists (our ship or worker RPC was fenced, or
        a valid higher-epoch ship arrived): stop acting as primary.
        Queued jobs fail structured ``not_primary`` — the new primary
        replays them from the replicated WAL under their original ids,
        so the structured answer is a redirect, not a loss."""
        with self._promote_lock:
            with self._lock:
                if self.role == "standby":
                    self._seen_epoch = max(
                        self._seen_epoch, int(higher_epoch)
                    )
                    if primary:
                        self._primary_hint = str(primary)
                    return
                self.role = "standby"
                self._seen_epoch = max(self._seen_epoch, int(higher_epoch))
                self._fenced_by = int(higher_epoch)
                if primary:
                    self._primary_hint = str(primary)
                elif self.cfg.ship_to:
                    self._primary_hint = self.cfg.ship_to
                hint = self._primary_hint
            if self.receiver is not None:
                self.receiver.touch()  # fresh lease: don't instantly re-promote
            obs.event("serve.takeover", role="standby",
                      epoch=int(higher_epoch), reason="fenced")
            logger.warning(
                "serve daemon FENCED by epoch %d (primary %s): demoting "
                "to standby", higher_epoch, hint or "unknown",
            )
            shipper = self.shipper
            if shipper is not None:
                self.journal.on_append = None
                self.shipper = None
                shipper.stop()
            stranded = self.scheduler.drain()
            if stranded:
                with self._lock:
                    for job in stranded:
                        self._corpus_pop(job.job_id)
                self._fail_batch(stranded, structured_error(
                    "not_primary",
                    "this daemon was demoted to standby mid-queue; the "
                    "new primary replays this job from the replicated "
                    "journal under the same id"
                    + (f" (primary {hint})" if hint else ""),
                ))

    def _maybe_lease_promote(self) -> None:
        """Standby lease expiry -> automatic takeover.  Runs on the
        dispatcher's idle tick; the explicit `promote` command is the
        other trigger."""
        if self.cfg.lease_s is None or self.receiver is None:
            return
        with self._lock:
            if self.role == "primary":
                return
        age = self.receiver.contact_age_s()
        if age is not None and age >= self.cfg.lease_s:
            logger.warning(
                "primary lease expired (%.1fs > %.1fs without contact)",
                age, self.cfg.lease_s,
            )
            self._promote(reason="lease")

    def _replication_stats(self) -> dict:
        with self._lock:
            out = {
                "role": self.role,
                "epoch": self.epoch,
                "seen_epoch": self._seen_epoch,
                "fenced_by": self._fenced_by,
                "primary_hint": self._primary_hint,
                "lease_s": self.cfg.lease_s,
            }
        shipper = self.shipper  # snapshot: _demote may null it mid-call
        if shipper is not None:
            out["ship"] = shipper.stats()
        if self.receiver is not None:
            out["standby"] = self.receiver.stats()
        return out

    # ----------------------------------------------------------- dispatch

    def _batch_key(self, job: Job):
        # bisect_group keeps the halves of a failed batch from
        # re-coalescing (jobs.Job.bisect_group): None for never-failed
        # jobs, so the common path batches exactly as before.  The
        # engine_key half already folds the PLAN fingerprint in for plan
        # jobs (cache.ExecutableCache.engine_key), so two different
        # pipelines can never coalesce.
        key = (
            self.executables.engine_key(job.spec), job.bucket,
            job.bisect_group,
        )
        if job.spec.plan is not None:
            # Plan jobs dispatch solo: a compiled plan runs one corpus
            # end-to-end (no vmapped job axis), so nothing may coalesce
            # with it — same stance as shard-eligible jobs.
            return key + (("solo", job.job_id),)
        if self.pool is not None and self._shardable(job):
            # Shard-eligible jobs dispatch solo: the fan-out owns the
            # whole batch, so nothing may coalesce with it.
            return key + (("solo", job.job_id),)
        # Cache affinity deliberately does NOT ride the key: the warm
        # set is itself keyed by (engine_key, bucket) — components
        # already in the key — so appending it could never change which
        # jobs coalesce; placement happens per-BATCH in pool.place(),
        # where the affinity decision actually lives.
        return key

    def _affinity_key(self, job: Job) -> tuple:
        return (self.executables.engine_key(job.spec), job.bucket)

    def _plan_affinity_key(self, job: Job, shape) -> tuple:
        """Pool-affinity key for a DISTRIBUTED plan job: the shape's
        primary node closure fingerprint in the workers' fold_node_key
        spelling (cache.ExecutableCache), so placement prefers workers
        already holding the compiled stage executable — alpha-renamed
        resubmits included — and a restarted daemon re-learns those
        homes from seed_affinity's warm_shapes rows."""
        from locust_tpu_torch.plan import distribute
        from locust_tpu_torch.serve.jobs import PLAN_WORKLOAD

        if isinstance(shape, distribute.JoinShape):
            fp = shape.leaves[0].node_fp
        else:
            fp = shape.node_fp
        return ((PLAN_WORKLOAD, f"node:{fp}"), job.bucket)

    def _shardable(self, job: Job) -> bool:
        # Plan jobs take their OWN distribution path (_plan_distributable
        # -> _dispatch_plan_distributed): the worker serve surface here
        # speaks (workload, config) batches, not plan stages.
        return (
            self.pool is not None
            and job.spec.plan is None
            and self.cfg.shard_max >= 2
            and job.n_blocks >= self.cfg.shard_min_blocks
        )

    def _plan_shape(self, job: Job):
        """(shape, reason) for a plan job: the distributable shape —
        fold spine, join tree, or pagerank iterate — or None with the
        reason it stays solo (plan/distribute.py, docs/PLAN.md
        "Distributed execution")."""
        if job.spec.plan is None:
            return None, "not_a_plan"
        try:
            from locust_tpu_torch.plan import distribute, from_json

            return distribute.plan_shape(from_json(job.spec.plan))
        except Exception as e:  # noqa: BLE001 - unrecognized plan = solo
            logger.debug(
                "plan job %s not distributable (%s: %s); solo engine",
                job.job_id, type(e).__name__, e,
            )
            return None, f"shape_error:{type(e).__name__}"

    def _count_plan_solo(self, reason: str) -> None:
        """A pool-eligible plan job fell back to the solo engine: count
        it (stats pool.plan ``plan_solo_fallbacks`` + the closed obs
        registry) and log once per distinct reason — the fused_demoted
        stance: an operator watching a 2-worker pool buy nothing for
        their pipeline finds out WHY, not never."""
        with self._lock:
            self._plan_counters["plan_solo_fallbacks"] += 1
            first = reason not in self._plan_solo_logged
            self._plan_solo_logged.add(reason)
        obs.metric_inc("plan.solo_fallbacks")
        if first:
            logger.warning(
                "plan job demoted to the solo engine (%s); further "
                "demotions for this reason are counted, not logged "
                "(stats pool.plan plan_solo_fallbacks)", reason,
            )

    def _plan_distributable(self, job: Job) -> bool:
        """Large plan jobs whose DAG matches a covered shape fan their
        stages across the pool; everything else keeps the solo engine —
        the floor, and the byte-identity anchor the distributed path is
        measured against (docs/PLAN.md "Distributed execution").  A
        pool-eligible job that fails ONLY the shape check is a counted,
        logged demotion (never silent)."""
        if (
            self.pool is None
            or job.spec.plan is None
            or self.cfg.shard_max < 2
            or job.n_blocks < self.cfg.shard_min_blocks
        ):
            return False
        shape, reason = self._plan_shape(job)
        if shape is None:
            self._count_plan_solo(reason or "unrecognized_shape")
            return False
        return True

    def _dispatch_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                self._dispatch_once()
            except Exception:  # noqa: BLE001 - the dispatcher must survive
                logger.exception("serve dispatch iteration failed")

    def _sweep_deadlines(self) -> None:
        """Expire queued/retrying jobs whose deadline passed — the
        structured ``deadline_exceeded`` answer must not wait for a
        dispatch slot the job will never productively use."""
        expired = self.scheduler.expire(time.monotonic())
        if not expired:
            return
        with self._lock:
            for j in expired:
                self._corpus_pop(j.job_id)
        self._fail_jobs([
            (j, structured_error(
                "deadline_exceeded",
                f"deadline of {j.spec.deadline_s}s expired while "
                f"{j.state} (attempt {j.attempts}/{j.spec.max_attempts})",
            ))
            for j in expired
        ])

    def _dispatch_once(self) -> None:
        self._maybe_lease_promote()
        self._sweep_deadlines()
        # Only an occupied queue is worth a queue-wait span: an idle
        # daemon's poll ticks would bury the timeline in no-op spans.
        cm = (
            obs.span("serve.queue_wait")
            if self.scheduler.depth()
            else contextlib.nullcontext()
        )
        # One batch per free placement slot, plus the local floor:
        # independent same-tick batches overlap across the pool instead
        # of serializing on one engine (the scale-out tentpole).  With
        # no pool this is exactly the old single-batch pop.
        limit = 1 + (self.pool.free_slots() if self.pool is not None else 0)
        with cm:
            batches = self.scheduler.next_batches(
                self._batch_key, max_batches=limit,
                timeout=self.cfg.dispatch_poll_s,
            )
        if not batches:
            return
        local: list[tuple[list[Job], dict]] = []
        for jobs in batches:
            jobs, corpora = self._pop_batch_corpora(jobs)
            if not jobs:
                continue
            # Chaos: the dispatch boundary.  "crash" models the dispatch
            # dying mid-flight, "error" an engine-side failure: either
            # way the batch enters the retry/bisection ladder.  When no
            # batch-level rule matches, one sub-fire per job carries
            # job=<id> so a plan can target ONE poison job.
            rule = faultplan.fire("serve.dispatch", jobs=len(jobs))
            if rule is None:
                for j in jobs:
                    rule = faultplan.fire(
                        "serve.dispatch", jobs=len(jobs), job=j.job_id
                    )
                    if rule is not None:
                        break
            if rule is not None:
                if rule.action == "delay":
                    time.sleep(rule.delay_s)
                else:
                    self._retry_or_fail(
                        jobs, corpora,
                        f"[faultplan] injected dispatch {rule.action}",
                    )
                    continue
            if len(jobs) == 1 and self._shardable(jobs[0]):
                # On the dedicated coordinator executor: the coordinator
                # blocks (bounded) on its shard futures and must not
                # park the dispatcher; the shard RPCs themselves overlap
                # on the pool executor.
                try:
                    self._shard_executor.submit(
                        self._dispatch_sharded, jobs[0], corpora
                    )
                except RuntimeError:  # executor shut down under us
                    self._fail_batch(jobs, structured_error(
                        "shutting_down",
                        "daemon shut down before this job was "
                        "dispatched; resubmit after it returns",
                    ))
                continue
            if len(jobs) == 1 and self._plan_distributable(jobs[0]):
                # Same coordinator stance as sharding: the plan
                # coordinator blocks (bounded) on its stage futures and
                # must not park the dispatcher.
                try:
                    self._shard_executor.submit(
                        self._dispatch_plan_distributed, jobs[0], corpora
                    )
                except RuntimeError:  # executor shut down under us
                    self._fail_batch(jobs, structured_error(
                        "shutting_down",
                        "daemon shut down before this job was "
                        "dispatched; resubmit after it returns",
                    ))
                continue
            worker = (
                self.pool.place(self._affinity_key(jobs[0]))
                if self.pool is not None and jobs[0].spec.plan is None
                else None
            )
            if worker is not None:
                try:
                    self.pool.submit(
                        self._dispatch_remote, worker, jobs, corpora
                    )
                except RuntimeError:  # pool closed between place/submit
                    self.pool.release(worker)
                    local.append((jobs, corpora))
            else:
                local.append((jobs, corpora))
        for jobs, corpora in local:
            self._dispatch_local(jobs, corpora)
        self._maybe_mark_warm()
        if self.journal is not None and self.journal.compact_due():
            self._compact_journal()

    def _pop_batch_corpora(
        self, jobs: list[Job]
    ) -> tuple[list[Job], dict]:
        """Flip a popped batch to running and collect its buffered
        corpora; jobs whose bytes vanished fail structured."""
        now = time.monotonic()
        with self._lock:
            corpora: dict = {}
            lost = []
            for j in jobs:
                j.state = "running"
                j.started_s = now
                j.batch_size = len(jobs)
                # None = the entry is MISSING (an empty submit stores
                # b"").  A silent b"" default here would fold an all-zero
                # stack and hand the client an empty "done" — the silent
                # wrong answer this tier forbids — so a lost entry fails
                # the job structurally instead.
                data = self._corpus_pop(j.job_id)
                if data is None and j.corpus_digest not in corpora:
                    lost.append(j)
                else:
                    if data is not None:
                        corpora[j.corpus_digest] = data
        if lost:
            self._fail_batch(lost, structured_error(
                "dispatch_failed",
                "in-flight corpus bytes missing at dispatch (daemon "
                "bug) — resubmit",
            ))
            jobs = [j for j in jobs if j not in lost]
        return jobs, corpora

    def _dispatch_local(self, jobs: list[Job], corpora: dict) -> None:
        """One batch on the daemon's own engine — the pre-pool path and
        the pool's permanent floor."""
        if jobs[0].spec.plan is not None:
            return self._dispatch_plan(jobs[0], corpora)
        spec = jobs[0].spec
        njobs_padded = batching.bucket_blocks(len(jobs))
        bucket = jobs[0].bucket
        for j in jobs:
            j.placed_on = "local"
        try:
            # One card: the whole device region — the engine build, the
            # staging copy, the fold, and the demux device->host reads —
            # holds the engine lock; only host pairs leave it.
            with self._engine_lock:
                with obs.span(
                    "serve.compile_or_hit",
                    jobs=len(jobs), bucket=bucket,
                ):
                    engine, hit = self.executables.lookup(
                        spec, njobs_padded, bucket
                    )
                # Literal names per branch, so every emission site names
                # its registry entry (obs/names.py).
                if hit:
                    obs.metric_inc("serve.exec_cache_hits")
                else:
                    obs.metric_inc("serve.exec_cache_misses")
                with obs.span(
                    "serve.dispatch", jobs=len(jobs), bucket=bucket
                ):
                    results = batching.dispatch_batch(
                        engine, jobs, corpora
                    )
                self.executables.mark_compiled(spec, njobs_padded, bucket)
                # Demux stays INSIDE the failure boundary:
                # to_host_pairs() is the device->host read, where an
                # asynchronous CUDA error of the fold surfaces — an
                # escape here would leave jobs "running" forever, a hang
                # where the tier promises a structured error.  _fail_batch skips the jobs already marked
                # done, so a mid-demux failure keeps the finished
                # results and fails only the rest.
                with obs.span("serve.demux", jobs=len(jobs)):
                    done = time.monotonic()
                    for job, res in zip(jobs, results):
                        pairs = res.to_host_pairs()
                        self._finish_job(
                            job, pairs, res.num_segments, res.truncated,
                            res.overflow_tokens,
                            "warm" if hit else "cold", done,
                        )
        except Exception as e:  # noqa: BLE001 - jobs retry/fail, daemon survives
            logger.exception("serve dispatch failed")
            self._retry_or_fail(jobs, corpora, f"{type(e).__name__}: {e}")

    def _dispatch_plan(self, job: Job, corpora: dict) -> None:
        """One plan job on the daemon's own engine (docs/PLAN.md).

        The warm-executable cache holds the COMPILED PLAN keyed by
        (plan fingerprint, config fingerprint, shape bucket) — a repeat
        of the same pipeline skips lowering and reuses the plan's
        engine, the warm-hit accounting named workloads get.  The result is the sink-rendered output bytes as
        ONE (bytes, 0) pair, so the result cache, warm persistence,
        history byte caps and journal replay all carry it unchanged;
        failures feed the same retry ladder as every other dispatch.
        """
        spec = job.spec
        try:
            with self._engine_lock:
                with obs.span(
                    "serve.compile_or_hit", jobs=1, bucket=job.bucket,
                ):
                    executor, hit = self.executables.lookup(
                        spec, 1, job.bucket
                    )
                if hit:
                    obs.metric_inc("serve.exec_cache_hits")
                else:
                    obs.metric_inc("serve.exec_cache_misses")
                job.placed_on = "local"
                with obs.span(
                    "serve.dispatch", jobs=1, bucket=job.bucket,
                ):
                    pres = executor.run_corpus(
                        corpora[job.corpus_digest],
                        sub_cache=self.subplans,
                        corpus_sha=job.corpus_digest,
                    )
                self.executables.mark_compiled(spec, 1, job.bucket)
                with obs.span("serve.demux", jobs=1):
                    self._finish_job(
                        job, [(pres.output, 0)], pres.distinct,
                        pres.truncated, pres.overflow_tokens,
                        "warm" if hit else "cold", time.monotonic(),
                    )
        except PlanError as e:
            # DETERMINISTIC rejection (e.g. a pagerank plan over a
            # corpus that does not parse as an edge list): retrying
            # would burn the whole backoff ladder on the same answer
            # and quarantine a well-formed submit as a misleading
            # poison_job — fail structured immediately instead, the
            # same bad_spec discipline admission applies.
            self._fail_batch([job], structured_error(
                "bad_spec",
                f"plan execution rejected the corpus: {e}",
            ))
        except Exception as e:  # noqa: BLE001 - retry ladder absorbs it
            logger.exception("serve plan dispatch failed")
            self._retry_or_fail(
                [job], corpora, f"plan: {type(e).__name__}: {e}"
            )

    def _dispatch_remote(
        self, worker, jobs: list[Job], corpora: dict
    ) -> None:
        """One batch on one pool worker (runs on the pool executor).

        Any failure — the worker dying mid-batch, a structured worker
        error, an injected fault — feeds the jobs back through the SAME
        retry/bisection ladder as a local failure: the pool quarantines
        the worker (WorkerHealth backoff) and the retry lands on a
        survivor or the local floor, so a worker death costs latency,
        never an answer.
        """
        try:
            try:
                # Worker-scoped chaos fire: a plan matching worker=<name>
                # models THIS worker dying mid-serve-batch.
                rule = faultplan.fire(
                    "serve.dispatch", jobs=len(jobs), worker=worker.name
                )
                if rule is not None:
                    if rule.action == "delay":
                        time.sleep(rule.delay_s)
                    else:
                        raise PoolDispatchError(
                            f"[faultplan] injected dispatch {rule.action} "
                            f"on worker {worker.name}"
                        )
                bucket = jobs[0].bucket
                for j in jobs:
                    j.placed_on = worker.name
                req_jobs = [
                    {"job_id": j.job_id, "sha": j.corpus_digest,
                     "n_lines": j.n_lines}
                    for j in jobs
                ]
                with obs.span(
                    "serve.dispatch",
                    jobs=len(jobs), bucket=bucket, worker=worker.name,
                ):
                    reply = self.pool.dispatch(
                        worker, jobs[0].spec.workload,
                        jobs[0].config_overrides or {}, bucket,
                        req_jobs, corpora,
                    )
                self.pool.mark_warm(worker, self._affinity_key(jobs[0]))
                hit = bool(reply.get("warm"))
                results = reply["results"]
                with obs.span("serve.demux", jobs=len(jobs)):
                    done = time.monotonic()
                    for job, res in zip(jobs, results):
                        pairs = [
                            (base64.b64decode(k), int(v))
                            for k, v in res["pairs"]
                        ]
                        self._finish_job(
                            job, pairs, int(res["distinct"]),
                            bool(res["truncated"]),
                            int(res["overflow_tokens"]),
                            "warm" if hit else "cold", done,
                        )
            except Exception as e:  # noqa: BLE001 - retry ladder absorbs it
                logger.warning(
                    "serve pool dispatch on %s failed: %s: %s",
                    worker.name, type(e).__name__, e,
                )
                if getattr(e, "code", None) == "stale_epoch":
                    # The worker has served a NEWER primary: we are the
                    # fenced-out zombie.  Demote with the worker's OWN
                    # high-water epoch when it sent one — the new
                    # primary replays these jobs from the replicated
                    # WAL; the retry ladder below still answers them
                    # structured here.
                    worker_epoch = getattr(e, "epoch", None)
                    with self._lock:
                        fence = max(
                            self._seen_epoch, self.epoch + 1,
                            int(worker_epoch or 0),
                        )
                    self._demote(fence)
                self._retry_or_fail(
                    jobs, corpora,
                    f"pool worker {worker.name}: {type(e).__name__}: {e}",
                )
        finally:
            self.pool.release(worker)
        self._maybe_mark_warm()

    def _dispatch_sharded(self, job: Job, corpora: dict) -> None:
        """Fan one large job across the pool and merge through the
        engine's combine (docs/SERVING.md "Scale-out dispatch").

        The corpus moves ONCE through the content-addressed spill; each
        worker folds a contiguous block-aligned line range and the
        partial tables merge with the same sort+segment-reduce the
        hierarchical mesh trusts — byte-identical to the local fold in
        the non-truncated regime.  Fewer than 2 placeable workers (or
        any shard failing) degrades to the local floor / retry ladder.
        """
        from locust_tpu_torch.serve import pool as pool_mod

        cfg = job.spec.cfg
        corpus = corpora.get(job.corpus_digest, b"")
        ranges = pool_mod.shard_ranges(
            job.n_lines, cfg.block_lines, self.cfg.shard_max
        )
        placements = []
        submitted: list = []
        used: set[int] = set()
        try:
            if len(ranges) >= 2:
                shard_blocks = -(-(ranges[0][1] - ranges[0][0])
                                 // cfg.block_lines)
                akey = (
                    self.executables.engine_key(job.spec),
                    batching.bucket_blocks(shard_blocks),
                )
                for _ in ranges:
                    w = self.pool.place(akey, exclude=used)
                    if w is None:
                        break
                    used.add(w.idx)
                    placements.append(w)
            if len(placements) < 2:
                for w in placements:
                    self.pool.release(w)
                placements = []
                self._dispatch_local([job], corpora)
                return
            if len(placements) < len(ranges):
                ranges = pool_mod.shard_ranges(
                    job.n_lines, cfg.block_lines, len(placements)
                )
                for w in placements[len(ranges):]:
                    self.pool.release(w)
                placements = placements[: len(ranges)]
            job.shards = len(ranges)
            job.placed_on = "shard:" + ",".join(
                w.name for w in placements
            )
            self.pool.spill(job.corpus_digest, corpus)
            futs = []
            for (a, b), w in zip(ranges, placements):
                fut = self.pool.submit(self._run_shard_rpc, w, job, a, b)
                # The slot release rides the FUTURE, not the
                # coordinator: on a wait timeout the RPC is still
                # holding the worker's dispatch lane, and an early
                # release would let place() queue a second batch behind
                # the stuck connection.
                fut.add_done_callback(
                    lambda _f, _w=w: self.pool.release(_w)
                )
                submitted.append(w)
                futs.append(fut)
            done_f, not_done = concurrent.futures.wait(
                futs, timeout=self.cfg.pool_rpc_timeout + 30.0
            )
            if not_done:
                raise PoolDispatchError(
                    f"{len(not_done)} shard dispatch(es) still inflight "
                    f"after {self.cfg.pool_rpc_timeout + 30.0:.0f}s"
                )
            shard_results = [f.result(timeout=1.0) for f in futs]
            combine = WORKLOADS[job.spec.workload][1]
            # The merge is device work on the coordinator thread: it
            # serializes with every other local device touch.
            with self._engine_lock:
                pairs, distinct, truncated, overflow = (
                    batching.merge_shard_results(
                        shard_results, cfg, combine, device=self.device
                    )
                )
            self._finish_job(
                job, pairs, distinct, truncated, overflow, "shard",
                time.monotonic(),
            )
        except Exception as e:  # noqa: BLE001 - retry ladder absorbs it
            logger.warning(
                "sharded dispatch of %s failed: %s: %s",
                job.job_id, type(e).__name__, e,
            )
            self._retry_or_fail(
                [job], corpora,
                f"sharded dispatch: {type(e).__name__}: {e}",
            )
        finally:
            # Only reservations that never became a shard RPC release
            # here — submitted ones release via their future's callback
            # (which runs even when the coordinator timed out on them).
            for w in placements:
                if w not in submitted:
                    self.pool.release(w)

    def _run_shard_rpc(self, worker, job: Job, a: int, b: int) -> dict:
        """One shard of a fanned-out job on one worker (pool executor).
        Returns the decoded shard table; raises on any failure — the
        coordinator fails the whole job into the retry ladder."""
        from locust_tpu_torch.serve import pool as pool_mod

        cfg = job.spec.cfg
        shard_id = pool_mod.stable_shard_id(job.job_id, a, b)
        sbucket = batching.bucket_blocks(-(-(b - a) // cfg.block_lines))
        rule = faultplan.fire(
            "serve.dispatch", jobs=1, worker=worker.name, job=shard_id
        )
        if rule is not None:
            if rule.action == "delay":
                time.sleep(rule.delay_s)
            else:
                raise PoolDispatchError(
                    f"[faultplan] injected shard {rule.action} on "
                    f"worker {worker.name}"
                )
        with obs.span(
            "serve.dispatch", jobs=1, bucket=sbucket, worker=worker.name,
        ):
            reply = self.pool.dispatch(
                worker, job.spec.workload, job.config_overrides or {},
                sbucket,
                [{"job_id": shard_id, "sha": job.corpus_digest,
                  "n_lines": b - a, "line_start": a, "line_end": b}],
                {},  # corpus already spilled by the coordinator
            )
        self.pool.mark_warm(
            worker, (self.executables.engine_key(job.spec), sbucket)
        )
        res = reply["results"][0]
        return {
            "pairs": [
                (base64.b64decode(k), int(v)) for k, v in res["pairs"]
            ],
            "distinct": int(res["distinct"]),
            "truncated": bool(res["truncated"]),
            "overflow_tokens": int(res["overflow_tokens"]),
        }

    def _run_plan_stage_rpc(self, worker, req: dict, phase: str) -> dict:
        """One plan stage RPC on one worker (pool executor).  Raises
        ``PoolDispatchError`` on ANY failure — transport death, a
        structured worker answer (carrying code/epoch/lost_split), an
        injected fault — the coordinator's wave runner owns recovery."""
        # Worker-scoped chaos fire (the serve.dispatch shard mold):
        # models THIS stage RPC dying in flight, coordinator side.
        rule = faultplan.fire(
            "plan.stage", phase=phase, worker=worker.name,
            split=req.get("split"), part=req.get("part"),
        )
        if rule is not None:
            if rule.action == "delay":
                time.sleep(rule.delay_s)
            else:
                raise PoolDispatchError(
                    f"[faultplan] injected plan stage {rule.action} on "
                    f"worker {worker.name}"
                )
        with obs.span(
            "plan.stage", phase=phase, worker=worker.name,
            split=req.get("split"), part=req.get("part"),
        ):
            return self.pool.stage_rpc(worker, req)

    def _dispatch_plan_distributed(self, job: Job, corpora: dict) -> None:
        """Fan one covered-shape plan across the pool as stage programs
        (docs/PLAN.md "Distributed execution").

        Fold spines (StageShape) — map wave: each contiguous
        block-aligned source split folds on a worker's warm fold-node
        executables (cache.fold_node_key: a repeat plan skips the
        per-worker recompile) and publishes its shuffle partitions
        atomically into the content-addressed spill.  Reduce wave: each
        partition's inputs move worker-to-worker over the binary data
        plane and combine on the reducing worker.  Finalize folds the
        reduced partitions into the solo renderer's EXACT bytes on the
        daemon — byte-identity to the solo engine is the contract.

        Join trees (JoinShape) run the SAME map wave once (every leaf
        is the one corpus wordcount fold) and then a join wave: each
        co-partitioned bin merges its inputs and evaluates the WHOLE
        tree locally, however deep — chained per-worker stage programs,
        no master round-trip between joins.  Two explicit identity
        gates demote to solo (counted, logged): any truncated/overflow
        map split, or total distinct past the solo fold's table
        capacity — outside both, the solo leaves are provably exact and
        the host merge reproduces them bit-for-bit.

        Pagerank (IterateShape) runs as epoch-synchronized sweeps: each
        worker owns a contiguous rank shard, computes one bit-exact
        ``pagerank_step`` per epoch over its dst-restricted edge subset
        and publishes its slice; the next epoch's stages reconstruct
        the full vector from ALL shards' partitions (the one shuffle
        per iteration).  Completed epochs journal as WAL stage records,
        so a SIGKILL mid-iteration resumes from the last fully-intact
        epoch's partitions; a lost shard partition recomputes exactly
        that (epoch, shard) stage.

        Robustness is STAGE-granular: a failed/dead worker's stage
        recomputes on a survivor from its durable inputs (never a
        full-plan restart; a reduce that lost a partition names the
        ``lost_split`` and exactly that map split recomputes),
        stragglers past ``plan_speculate_s`` get one speculative backup
        (first finisher wins — attempt-keyed filenames cannot collide),
        completed map splits journal as stage-progress records so a
        daemon restart reuses surviving partitions, and every stage RPC
        carries the fencing epoch so a zombie coordinator's publishes
        die structured ``stale_epoch``.  Fewer than 2 placeable workers
        (or any unrecognized shape upstream) = the solo floor.
        """
        from locust_tpu_torch.plan import distribute
        from locust_tpu_torch.plan.compile import (
            SERVE_MAX_PAGERANK_NODES, edges_from_bytes,
        )
        from locust_tpu_torch.serve import pool as pool_mod

        shape, shape_reason = self._plan_shape(job)
        cfg = job.spec.cfg
        corpus = corpora.get(job.corpus_digest, b"")
        plan_fp = job.spec.plan_fingerprint()
        placements: list = []
        used: set[int] = set()
        part_files: set[str] = set()
        try:
            if shape is None:
                raise _PlanSolo(shape_reason or "unrecognized_shape")
            is_iter = isinstance(shape, distribute.IterateShape)
            is_join = isinstance(shape, distribute.JoinShape)
            ranges: list = []
            num_nodes = 0
            if is_iter:
                if shape.num_iters < 1:
                    # Zero sweeps = ranks0; no epoch partitions would
                    # exist to finalize from — the solo scan owns it.
                    raise _PlanSolo("iterate_no_epochs")
                # The edge list names the dense node space (PlanError
                # here = the same bad_spec the solo evaluator answers).
                src, dst = edges_from_bytes(corpus)
                num_nodes = int(max(int(src.max()), int(dst.max()))) + 1
                if num_nodes > SERVE_MAX_PAGERANK_NODES:
                    # The solo path raises the canonical bad_spec text.
                    raise _PlanSolo("pagerank_node_cap")
                n_tasks = min(self.cfg.shard_max, num_nodes)
            else:
                ranges = pool_mod.shard_ranges(
                    job.n_lines, cfg.block_lines, self.cfg.shard_max
                )
                n_tasks = len(ranges)
            akey = self._plan_affinity_key(job, shape)
            if n_tasks >= 2:
                for _ in range(n_tasks):
                    w = self.pool.place(akey, exclude=used)
                    if w is None:
                        break
                    used.add(w.idx)
                    placements.append(w)
            if len(placements) < 2:
                raise _PlanSolo("insufficient_workers")
            if not is_iter and len(placements) < len(ranges):
                # Same reconciliation as sharding: re-derive the splits
                # for the workers we actually hold — never drop lines.
                ranges = pool_mod.shard_ranges(
                    job.n_lines, cfg.block_lines, len(placements)
                )
                for w in placements[len(ranges):]:
                    self.pool.release(w)
                placements = placements[: len(ranges)]
            n_splits = len(ranges)
            n_parts = len(placements)
            job.shards = n_parts if is_iter else n_splits
            job.placed_on = "plan:" + ",".join(w.name for w in placements)
            self.pool.spill(job.corpus_digest, corpus)
            dead: set[int] = set()
            rr = 0

            def next_worker():
                nonlocal rr
                for _ in range(len(placements)):
                    w = placements[rr % len(placements)]
                    rr += 1
                    if w.idx not in dead:
                        return w
                return None

            # WAL-replayed stage progress (map split or iterate epoch
            # records — they self-discriminate by key): popped once, the
            # shape branch below decides what resumes.
            with self._lock:
                progress = self._plan_progress.pop(job.job_id, [])

            def run_wave(phase, task_ids, build_req, repair=None,
                         on_win=None):
                """One wave of stage RPCs: per-task retry (capped),
                straggler speculation (first finisher wins), rotation
                over the surviving held placements."""
                pending: dict = {}
                won: dict[int, dict] = {}
                attempts = {t: 0 for t in task_ids}
                started: dict[int, float] = {}
                speculated: set[int] = set()
                deadline = (
                    time.monotonic() + self.cfg.pool_rpc_timeout + 30.0
                )

                def launch(task):
                    w = next_worker()
                    if w is None:
                        raise PoolDispatchError(
                            "no surviving plan-stage workers"
                        )
                    fut = self.pool.submit(
                        self._run_plan_stage_rpc, w,
                        build_req(task, attempts[task]), phase,
                    )
                    attempts[task] += 1
                    started[task] = time.monotonic()
                    pending[fut] = (task, w)

                for t in task_ids:
                    launch(t)
                while len(won) < len(task_ids):
                    if time.monotonic() > deadline:
                        raise PoolDispatchError(
                            f"plan {phase} wave still inflight after "
                            f"{self.cfg.pool_rpc_timeout + 30.0:.0f}s"
                        )
                    done_f, _ = concurrent.futures.wait(
                        list(pending), timeout=0.25,
                        return_when=concurrent.futures.FIRST_COMPLETED,
                    )
                    for fut in done_f:
                        task, w = pending.pop(fut)
                        try:
                            reply = fut.result(timeout=1.0)
                        except Exception as e:  # noqa: BLE001 - per-task retry
                            if getattr(e, "code", None) == "stale_epoch":
                                raise  # the outer fence handler owns it
                            if task in won:
                                continue  # a speculative loser died
                            if (getattr(e, "lost_split", None) is None
                                    and getattr(e, "lost_epoch", None)
                                    is None):
                                # Transport-level death.  A structured
                                # loss report is the ANSWERING worker
                                # doing its job (a dead peer's partition
                                # is the casualty) — marking it dead too
                                # would strand a 2-worker pool with one
                                # real death on the solo floor.
                                dead.add(w.idx)
                            if attempts[task] >= 3 \
                                    or next_worker() is None:
                                raise
                            with self._lock:
                                self._plan_counters["recomputes"] += 1
                            obs.metric_inc("plan.recomputes")
                            if repair is not None:
                                repair(task, e)
                            launch(task)
                            continue
                        if reply.get("parts"):
                            part_files.update(
                                str(p["path"]) for p in reply["parts"]
                            )
                        ref = reply.get("ref")
                        if isinstance(ref, dict) and ref.get("path"):
                            # Iterate replies publish ONE shard slice —
                            # tracked even for speculative losers so no
                            # epoch partition outlives the job.
                            part_files.add(str(ref["path"]))
                        if task in won:
                            continue  # first finisher already won
                        won[task] = reply
                        with self._lock:
                            self._plan_counters["stages"] += 1
                        if on_win is not None:
                            on_win(task, reply, w)
                    now = time.monotonic()
                    for t in task_ids:
                        if (t in won or t in speculated
                                or now - started[t]
                                <= self.cfg.plan_speculate_s
                                or next_worker() is None):
                            continue
                        speculated.add(t)
                        with self._lock:
                            self._plan_counters["speculated"] += 1
                        obs.metric_inc("plan.speculated")
                        launch(t)
                return won

            if is_iter:
                # ---- pagerank: epoch-synchronized rank-shard sweeps --
                n_shards = n_parts
                epoch_refs: dict[int, dict[int, dict]] = {}

                def journal_epoch(epoch: int, refs: dict) -> None:
                    if self.journal is not None:
                        self.journal.append_stage(job.job_id, {
                            "epoch": epoch,
                            "n_shards": n_shards,
                            "parts": [refs[s] for s in range(n_shards)],
                        })

                # WAL-replayed epoch progress: resume from the HIGHEST
                # fully-intact journaled epoch (every shard slice present
                # with its recorded sha) — a daemon restart re-runs only
                # the sweeps past it, byte-identically (each epoch is a
                # pure function of the previous epoch's partitions).
                best = 0
                best_refs: dict[int, dict] = {}
                for st in progress:
                    try:
                        e_no = int(st.get("epoch", -1))
                        parts = list(st.get("parts") or [])
                        if (e_no <= best or e_no > shape.num_iters
                                or int(st.get("n_shards", -1)) != n_shards
                                or len(parts) != n_shards):
                            continue
                        for ref in parts:
                            with open(str(ref["path"]), "rb") as f:
                                data = f.read()
                            if (hashlib.sha256(data).hexdigest()
                                    != ref["sha256"]):
                                raise ValueError("partition sha drifted")
                        best = e_no
                        best_refs = {
                            int(r["part"]): dict(r) for r in parts
                        }
                    except Exception as e:  # noqa: BLE001 - damaged = recompute
                        logger.warning(
                            "plan resume: damaged epoch record skipped "
                            "(%s: %s); that epoch recomputes",
                            type(e).__name__, e,
                        )
                        continue
                if best:
                    epoch_refs[best] = best_refs
                    part_files.update(
                        str(r["path"]) for r in best_refs.values()
                    )
                    with self._lock:
                        self._plan_counters["partitions_reused"] += (
                            n_shards
                        )

                def inputs_for(epoch: int):
                    """The previous epoch's full partition set (None =
                    the uniform-ranks first sweep).  Read at BUILD time
                    so a mid-wave repair's fresh refs reach relaunched
                    and speculative attempts."""
                    if epoch < 1:
                        return None
                    refs = epoch_refs[epoch]
                    return [dict(refs[s]) for s in range(n_shards)]

                def build_iter_req(epoch: int):
                    def build(shard: int, attempt: int) -> dict:
                        return {
                            "phase": "iterate",
                            "sha": job.corpus_digest,
                            "spill_dir": self.pool.spill_dir,
                            "plan_fp": plan_fp,
                            "epoch": epoch, "shard": shard,
                            "n_shards": n_shards,
                            "num_nodes": num_nodes,
                            "damping": shape.damping,
                            "attempt": attempt,
                            "inputs": inputs_for(epoch - 1),
                            # split/part feed the chaos + obs stage ctx.
                            "split": epoch, "part": shard,
                        }
                    return build

                def repair_iterate(epoch: int):
                    def repair(shard: int, exc) -> None:
                        """A sweep lost one of the PREVIOUS epoch's
                        shard slices: recompute exactly that
                        (epoch-1, shard) stage on a survivor and
                        re-journal — the relaunched sweep reads the
                        fresh ref through inputs_for's closure.  The
                        recompute is deterministic, so the re-journaled
                        epoch is bit-identical to the original."""
                        le = getattr(exc, "lost_epoch", None)
                        ls = getattr(exc, "lost_split", None)
                        if le is None or ls is None:
                            return
                        le, ls = int(le), int(ls)
                        if le != epoch - 1 or le < 1:
                            return
                        w = next_worker()
                        if w is None:
                            raise PoolDispatchError(
                                "no surviving plan-stage workers"
                            )
                        old = epoch_refs[le][ls]
                        att = int(old.get("attempt", 0)) + 1
                        reply = self._run_plan_stage_rpc(
                            w, build_iter_req(le)(ls, att), "iterate"
                        )
                        ref = dict(
                            reply["ref"],
                            worker=reply.get("worker", ""),
                            attempt=att,
                        )
                        epoch_refs[le][ls] = ref
                        part_files.add(str(ref["path"]))
                        journal_epoch(le, epoch_refs[le])
                    return repair

                for epoch in range(best + 1, shape.num_iters + 1):
                    won = run_wave(
                        "iterate", list(range(n_shards)),
                        build_iter_req(epoch),
                        repair=repair_iterate(epoch),
                    )
                    refs = {}
                    for shard, reply in won.items():
                        refs[int(reply.get("shard", shard))] = dict(
                            reply["ref"],
                            worker=reply.get("worker", ""),
                            attempt=int(reply.get("attempt", 0)),
                        )
                    epoch_refs[epoch] = refs
                    journal_epoch(epoch, refs)
                    # The rank-shuffle chaos window: published slices
                    # sit durable between epochs, same exposure as the
                    # fold shuffle's map->reduce gap.
                    for s in range(n_shards):
                        distribute.chaos_partition(
                            str(refs[s]["path"]), epoch, s
                        )
                # Finalize on the host: the final epoch's shard slices
                # concatenate (shard order IS node order) into the solo
                # renderer's exact bytes — pure numpy, no engine lock.
                final = epoch_refs[shape.num_iters]
                slices = []
                for s in range(n_shards):
                    ref = final[s]
                    pairs = distribute.read_partition(
                        str(ref["path"]), str(ref["sha256"]),
                        distribute.RANK_KEY_WIDTH,
                    )
                    slices.append(distribute.decode_rank_values(pairs))
                output, distinct, trunc, ovf = (
                    distribute.finalize_ranks(slices)
                )
                self._finish_job(
                    job, [(output, 0)], distinct, trunc, ovf,
                    "distributed", time.monotonic(),
                )
                return

            # ---- fold spines + join trees: one shared map wave ------
            # Every leaf of a covered join tree is the SAME corpus
            # wordcount fold, so ONE map wave serves however many
            # leaves the tree has.
            fold = "wordcount" if is_join else shape.fold
            map_node_fp = (
                shape.leaves[0].node_fp if is_join else shape.node_fp
            )
            lines_per_doc = 1 if is_join else shape.lines_per_doc

            def build_map_req(split: int, attempt: int) -> dict:
                a, b = ranges[split]
                return {
                    "phase": "map", "fold": fold,
                    "config": job.config_overrides or {},
                    "sha": job.corpus_digest,
                    "spill_dir": self.pool.spill_dir,
                    "plan_fp": plan_fp, "split": split,
                    "attempt": attempt, "n_parts": n_parts,
                    "line_start": a, "line_end": b,
                    "lines_per_doc": lines_per_doc,
                    # Keys the worker's warm fold-node executables: a
                    # repeat plan skips the per-worker recompile.
                    "node_fp": map_node_fp,
                }

            map_done: dict[int, dict] = {}

            def journal_stage(split: int, reply: dict) -> None:
                if self.journal is not None:
                    self.journal.append_stage(job.job_id, {
                        "split": split,
                        "attempt": int(reply.get("attempt", 0)),
                        "worker": reply.get("worker", ""),
                        "n_parts": n_parts,
                        "truncated": bool(reply.get("truncated")),
                        "overflow_tokens": int(
                            reply.get("overflow_tokens", 0)
                        ),
                        "parts": reply.get("parts", []),
                    })

            # Reuse a WAL-replayed completed split when the partition
            # layout matches and every file survived with its recorded
            # sha — a restart RESUMES the plan instead of remapping
            # everything (anything damaged just recomputes).
            for st in progress:
                try:
                    s = int(st.get("split", -1))
                    parts = list(st.get("parts") or [])
                    if (not 0 <= s < n_splits or s in map_done
                            or int(st.get("n_parts", -1)) != n_parts
                            or len(parts) != n_parts):
                        continue
                    for ref in parts:
                        with open(str(ref["path"]), "rb") as f:
                            data = f.read()
                        if (hashlib.sha256(data).hexdigest()
                                != ref["sha256"]):
                            raise ValueError("partition sha drifted")
                except Exception as e:  # noqa: BLE001 - damaged = recompute
                    logger.warning(
                        "plan resume: damaged stage record skipped "
                        "(%s: %s); that split recomputes",
                        type(e).__name__, e,
                    )
                    continue
                map_done[s] = dict(st)
                part_files.update(str(p["path"]) for p in parts)
                with self._lock:
                    self._plan_counters["partitions_reused"] += n_parts

            def on_map_win(split, reply, w):
                journal_stage(split, reply)
                self.pool.mark_warm(w, akey)
                if reply.get("warm"):
                    # The worker folded on an already-compiled fold-node
                    # executable (the warm-repeat economics, test- and
                    # bench-pinned: compiles stay flat on resubmit).
                    with self._lock:
                        self._plan_counters["map_warm_hits"] += 1
                    obs.metric_inc("plan.map_warm_hits")

            todo = [s for s in range(n_splits) if s not in map_done]
            if todo:
                map_done.update(run_wave(
                    "map", todo, build_map_req, on_win=on_map_win,
                ))
            truncated = any(
                bool(r.get("truncated")) for r in map_done.values()
            )
            overflow = sum(
                int(r.get("overflow_tokens", 0))
                for r in map_done.values()
            )
            # The shuffle-partition chaos window (docs/FAULTS.md): the
            # published files sit durable between the waves — exactly
            # where a GC race or disk loss would bite a real deployment.
            for s in sorted(map_done):
                for ref in map_done[s].get("parts", []):
                    distribute.chaos_partition(
                        str(ref["path"]), s, int(ref["part"])
                    )
            key_width = distribute.partition_key_width(cfg, fold)

            def partition_inputs(part: int) -> list:
                """One bin's per-split input refs, read at BUILD time so
                a mid-wave repair's fresh refs reach relaunches."""
                return [
                    dict(
                        map_done[s]["parts"][part], split=s,
                        worker=map_done[s].get("worker", ""),
                    )
                    for s in range(n_splits)
                ]

            def repair_map_input(part: int, exc) -> None:
                """A reduce/join attempt lost a partition input:
                recompute exactly that map split (attempt-bumped, on a
                survivor) and re-journal it — the relaunched stage reads
                the fresh refs through partition_inputs' closure."""
                s = getattr(exc, "lost_split", None)
                if s is None:
                    return
                s = int(s)
                w = next_worker()
                if w is None:
                    raise PoolDispatchError(
                        "no surviving plan-stage workers"
                    )
                attempt = int(map_done[s].get("attempt", 0)) + 1
                reply = self._run_plan_stage_rpc(
                    w, build_map_req(s, attempt), "map"
                )
                part_files.update(
                    str(p["path"]) for p in reply.get("parts", [])
                )
                map_done[s] = reply
                journal_stage(s, reply)

            if is_join:
                # ---- join wave: per-bin hash-join, tree-deep ---------
                # Identity gate 1: the solo leaves must be provably
                # untruncated (a truncated fold's table is not the exact
                # wordcount the solo join reads).
                if truncated or overflow:
                    raise _PlanSolo("join_fold_truncated")
                tree_wire = distribute.tree_doc(shape.tree)

                def build_join_req(part: int, attempt: int) -> dict:
                    return {
                        "phase": "join", "part": part,
                        "key_width": key_width,
                        "attempt": attempt,
                        "tree": tree_wire,
                        "inputs": partition_inputs(part),
                    }

                join_done = run_wave(
                    "join", list(range(n_parts)), build_join_req,
                    repair=repair_map_input,
                )
                # Identity gate 2: total distinct within the solo
                # fold's table capacity — past it the solo engine WOULD
                # have truncated, so the solo path must answer.
                total_distinct = sum(
                    int(join_done[p].get("distinct", 0))
                    for p in range(n_parts)
                )
                if total_distinct > cfg.resolved_table_size:
                    raise _PlanSolo("join_fold_capacity")
                # Host-side merge on purpose: join values are unbounded
                # Python ints (mul combines) — no engine lock needed.
                output, distinct, trunc, ovf = distribute.finalize_join([
                    [
                        (base64.b64decode(k), int(v))
                        for k, v in join_done[p].get("pairs", [])
                    ]
                    for p in range(n_parts)
                ])
                self._finish_job(
                    job, [(output, 0)], distinct, trunc, ovf,
                    "distributed", time.monotonic(),
                )
                return

            def build_reduce_req(part: int, attempt: int) -> dict:
                return {
                    "phase": "reduce", "part": part,
                    "key_width": key_width,
                    "attempt": attempt,
                    "inputs": partition_inputs(part),
                }

            reduce_done = run_wave(
                "reduce", list(range(n_parts)), build_reduce_req,
                repair=repair_map_input,
            )
            partition_pairs = [
                [
                    (base64.b64decode(k), int(v))
                    for k, v in reduce_done[p].get("pairs", [])
                ]
                for p in range(n_parts)
            ]
            # Finalize is device work (the wordcount re-merge) on the
            # coordinator thread: it serializes with every other local
            # device touch.
            with self._engine_lock:
                output, distinct, trunc, ovf = distribute.finalize(
                    shape, cfg, job.n_lines, partition_pairs,
                    truncated, overflow, device=self.device,
                )
            self._finish_job(
                job, [(output, 0)], distinct, trunc, ovf,
                "distributed", time.monotonic(),
            )
        except _PlanSolo as e:
            # The solo engine is the correctness floor: demote LOUDLY
            # (logged once per reason, counted in stats pool.plan —
            # never silent, the fused_demoted stance).  Placements go
            # back first so the solo run never starves the pool.
            for w in placements:
                self.pool.release(w)
            placements = []
            self._count_plan_solo(e.reason)
            self._dispatch_local([job], corpora)
        except PlanError as e:
            # Deterministic rejection — same bad_spec discipline as the
            # solo plan path (retrying cannot change the answer).
            self._fail_batch([job], structured_error(
                "bad_spec",
                f"plan execution rejected the corpus: {e}",
            ))
        except Exception as e:  # noqa: BLE001 - retry ladder absorbs it
            logger.warning(
                "distributed plan dispatch of %s failed: %s: %s",
                job.job_id, type(e).__name__, e,
            )
            if getattr(e, "code", None) == "stale_epoch":
                # A worker has served a NEWER primary: we are the
                # fenced-out zombie — no stale partition may publish.
                worker_epoch = getattr(e, "epoch", None)
                with self._lock:
                    fence = max(
                        self._seen_epoch, self.epoch + 1,
                        int(worker_epoch or 0),
                    )
                self._demote(fence)
            self._retry_or_fail(
                [job], corpora,
                f"distributed plan: {type(e).__name__}: {e}",
            )
        finally:
            # Held for the whole run (each worker serves several stage
            # RPCs); a straggler RPC still in flight past this release
            # is bounded by the worker's own rpc timeout.
            for w in placements:
                self.pool.release(w)
            # Shuffle partitions are scaffolding once the job settled —
            # the fsync'd admit record can always re-run the plan — so
            # drop them best-effort to keep the spill dir from accreting.
            for p in part_files:
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def _finish_job(
        self, job: Job, pairs: list, distinct, truncated, overflow,
        cache_label: str, done: float,
    ) -> None:
        """Publish one finished job — the demux core shared by the
        local, remote, and shard paths."""
        size = jobs_pairs_bytes(pairs)
        meta = {
            "distinct": int(distinct),
            "truncated": bool(truncated),
            "overflow_tokens": int(overflow),
        }
        if job.expired(done):
            # Deadline expiry ANYWHERE answers structured
            # deadline_exceeded — even when the result just landed: the
            # client stopped waiting at the budget it set.  The correct
            # result still feeds the result cache below, so a resubmit
            # of the same work is answered instantly.
            self._fail_jobs([(job, structured_error(
                "deadline_exceeded",
                f"deadline of {job.spec.deadline_s}s expired "
                "while the job was running; the result was "
                "cached — resubmit to fetch it",
            ))])
            if not job.spec.no_cache:
                self.results.put(
                    job.corpus_digest, job.spec.fingerprint(), pairs,
                    meta=meta,
                )
            return
        if not job.spec.no_cache:
            # The result cache first: a client that sees "done" and
            # resubmits the same work must find it cached.
            self.results.put(
                job.corpus_digest, job.spec.fingerprint(), pairs,
                meta=meta,
            )
        with self._lock:
            # state flips to "done" LAST: status/result handlers read
            # job fields without this lock, so the state write is the
            # publish barrier — a reader seeing "done" must also see the
            # result (done-with-None-result would answer an empty pairs
            # list as success) and the result cache's entry.
            job.cache = cache_label
            job.finished_s = done
            job.result = pairs
            job.result_bytes = size
            job.distinct = int(distinct)
            job.truncated = bool(truncated)
            job.overflow_tokens = int(overflow)
            job.state = "done"
            self._completed += 1
            self._result_bytes += size
            self._evict_history(keep=job.job_id)
        if self.journal is not None:
            self.journal.append_state(job.job_id, "done")
        obs.metric_inc("serve.jobs")
        obs.metric_observe("serve.latency_ms", job.latency_ms())

    def _maybe_mark_warm(self) -> None:
        """Latest-wins background warm generation: never blocks on disk
        (io/snapshot.py).  Distance-based cadence, not modulo:
        ``completed`` advances by batch size on three dispatch paths and
        by result-cache hits on handler threads, so no single thread may
        ever OBSERVE a multiple of warm_every — a modulo check could
        skip marks forever and silently demote the cadence to "clean
        shutdown only".  The cursor read+write holds the lock (close()
        snapshots the generation counter under it); the mark itself
        stays outside — it only enqueues on the async writer."""
        if self.warm is None:
            return
        with self._lock:
            completed = self._completed
            due = completed - self._warm_marked >= self.cfg.warm_every
            if due:
                self._warm_marked = completed
        if due:
            self.warm.mark(completed)

    # ---------------------------------------------------- retry/fail/journal

    @staticmethod
    def _retry_jitter(job_id: str, attempt: int) -> float:
        """Deterministic jitter fraction in [0, 1): same job + attempt ->
        same jitter on every run (the chaos matrix stays reproducible),
        different jobs -> decorrelated retries (no thundering herd)."""
        h = hashlib.sha256(f"{job_id}:{attempt}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    def _retry_or_fail(
        self, jobs: list[Job], corpora: dict, reason: str
    ) -> None:
        """One failed dispatch enters the retry ladder (docs/SERVING.md):

          * a multi-job batch BISECTS — the halves get distinct
            ``bisect_group`` tags so they can never re-coalesce, which
            isolates a poison job in log2(batch) extra dispatches while
            its innocent neighbors succeed on their own half;
          * each surviving job requeues with exponential backoff +
            deterministic jitter, bounded by its ``max_attempts`` budget
            and its deadline;
          * a job that exhausts attempts with its LAST kill being a SOLO
            dispatch is quarantined as structured ``poison_job`` (it
            demonstrably kills dispatches on its own); otherwise the
            terminal code is ``dispatch_failed``;
          * deadline expiry at any rung answers ``deadline_exceeded``.
        """
        now = time.monotonic()
        alive = [j for j in jobs if j.state != "done"]  # demuxed: stands
        solo = len(alive) == 1
        if len(alive) > 1:
            tag = uuid.uuid4().hex[:6]
            half = (len(alive) + 1) // 2
            for k, job in enumerate(alive):
                side = "L" if k < half else "R"
                job.bisect_group = f"{tag}.{side}"
        failures: list[tuple[Job, dict]] = []
        for job in alive:
            job.attempts += 1
            if job.expired(now):
                failures.append((job, structured_error(
                    "deadline_exceeded",
                    f"deadline of {job.spec.deadline_s}s expired after a "
                    f"failed dispatch (attempt {job.attempts}/"
                    f"{job.spec.max_attempts}; last error: {reason})",
                )))
                continue
            if job.attempts >= job.spec.max_attempts:
                if solo:
                    failures.append((job, structured_error(
                        "poison_job",
                        f"job killed {job.attempts} dispatch(es), the "
                        f"last one solo — quarantined (last error: "
                        f"{reason}); inspect the spec/corpus before "
                        "resubmitting",
                    )))
                else:
                    failures.append((job, structured_error(
                        "dispatch_failed",
                        f"dispatch failed {job.attempts} time(s), retry "
                        f"budget exhausted (last error: {reason})",
                    )))
                continue
            backoff = min(
                self.cfg.retry_cap_s,
                self.cfg.retry_base_s * 2.0 ** (job.attempts - 1),
            )
            backoff *= 1.0 + self._retry_jitter(job.job_id, job.attempts)
            not_before = now + backoff
            dm = job.deadline_mono()
            if dm is not None and not_before >= dm:
                failures.append((job, structured_error(
                    "deadline_exceeded",
                    f"deadline of {job.spec.deadline_s}s cannot fit "
                    f"another attempt after {job.attempts} failure(s) "
                    f"(last error: {reason})",
                )))
                continue
            data = corpora.get(job.corpus_digest)
            if data is None:
                failures.append((job, structured_error(
                    "dispatch_failed",
                    "in-flight corpus bytes missing at retry (daemon "
                    f"bug) — resubmit (last error: {reason})",
                )))
                continue
            with self._lock:
                if job.job_id not in self._corpus_bytes:
                    self._corpus_put(job.job_id, data)
                job.state = "retrying"
            if not self.scheduler.requeue(job, not_before):
                with self._lock:
                    self._corpus_pop(job.job_id)
                failures.append((job, structured_error(
                    "shutting_down",
                    "daemon shut down before this job could retry; "
                    "resubmit after it returns",
                )))
                continue
            obs.event(
                "serve.retry",
                job=job.job_id, attempt=job.attempts,
                backoff_ms=round(backoff * 1e3, 1),
                group=job.bisect_group,
            )
        if failures:
            self._fail_jobs(failures)

    def _fail_batch(self, jobs: list[Job], error: dict) -> None:
        self._fail_jobs([(j, error) for j in jobs])

    def _fail_jobs(self, failures: list[tuple[Job, dict]]) -> None:
        now = time.monotonic()
        with self._lock:
            for job, error in failures:
                if job.state == "done":
                    continue  # demuxed before the failure: result stands
                # error before state: the state write is the lock-free
                # readers' publish barrier (same rule as the demux path).
                job.error = dict(error)
                job.finished_s = now
                job.state = "failed"
        if self.journal is not None:
            for job, error in failures:
                if job.state == "failed":
                    self.journal.append_state(
                        job.job_id, "failed", error=error
                    )

    def _compact_journal(self) -> None:
        """Rewrite the journal down to the still-live jobs (and GC their
        orphaned corpus spills).  Liveness comes from the journal's OWN
        records under its lock (journal.compact) — a daemon-side job
        snapshot would race handler-thread admits fsync'd between the
        snapshot and the rewrite, silently dropping acked work.

        Replication-aware: compaction SHIPS as a snapshot barrier — the
        standby re-syncs to the compacted live set, so a catch-up that
        was mid-flight when the GC ran converges instead of stranding on
        swept spills (every swept spill's job has a terminal record
        already in the ship stream)."""
        self.journal.compact()
        shipper = self.shipper  # snapshot: _demote may null it mid-call
        if shipper is not None:
            shipper.barrier()

    def _replay_journal(self) -> None:
        """Crash recovery: re-enqueue every journaled job still owed an
        answer, under its ORIGINAL id (docs/SERVING.md durability):

          * terminal ``failed``/``cancelled`` records are restored as
            finished history, so a result fetch across the restart reads
            the same structured error;
          * ``done`` jobs whose (corpus sha, spec) is in the restored
            result cache are restored as done — byte-identical replay;
            done jobs the warm state had not yet persisted RE-ENQUEUE
            (the fold is deterministic, so the recompute is
            byte-identical too);
          * everything else re-enqueues from its spilled corpus; a
            missing/damaged spill is a structured failure, never a
            silent loss.  Deadline budgets re-anchor at replay time.
        """
        entries = self.journal.replay()
        requeued = restored = failed = dropped = 0
        now = time.monotonic()
        for entry in entries:
            rec = entry.admit
            term = entry.terminal
            if term is not None and term["state"] == "rejected":
                dropped += 1
                continue
            try:
                plan_json = None
                if rec.get("plan") is not None:
                    # Plan jobs journal the plan DOCUMENT in the admit
                    # record: replay re-validates it end-to-end (the
                    # same gate a fresh submit passes) so a record
                    # carrying a no-longer-valid plan fails structured
                    # below, never a dispatch-time surprise.
                    from locust_tpu_torch.plan import from_doc as plan_from_doc

                    plan_json = plan_from_doc(
                        rec["plan"]
                    ).canonical_json()
                elif rec["workload"] not in WORKLOADS:
                    raise ValueError(f"workload {rec['workload']!r}")
                overrides = dict(rec.get("config") or {})
                spec = JobSpec(
                    tenant=str(rec["tenant"]),
                    workload=str(rec["workload"]),
                    cfg=EngineConfig(**overrides),
                    weight=float(rec.get("weight", 1.0)),
                    no_cache=bool(rec.get("no_cache")),
                    deadline_s=rec.get("deadline_s"),
                    max_attempts=int(rec.get("max_attempts", 4)),
                    plan=plan_json,
                )
                n_lines = int(rec["n_lines"])
                n_blocks, bucket = batching.job_shape(n_lines, spec.cfg)
                job = Job(
                    job_id=str(rec["job_id"]),
                    spec=spec,
                    corpus_digest=str(rec["corpus_sha"]),
                    n_lines=n_lines,
                    n_blocks=n_blocks,
                    bucket=bucket,
                    config_overrides=overrides,
                )
            except Exception as e:  # noqa: BLE001 - one bad record
                logger.warning(
                    "journal replay: admit record unusable (%s: %s)",
                    type(e).__name__, e,
                )
                # The job was ACKED: silently dropping it answers
                # unknown_job, against the every-acked-job-answers
                # guarantee.  Remember it as failed with a structured
                # reason instead (a placeholder spec carries the record
                # through status/result; nothing ever dispatches it),
                # and journal the terminal state so compaction drops it.
                job_id = str(rec.get("job_id") or "")
                if not job_id:
                    dropped += 1
                    continue
                ghost = Job(
                    job_id=job_id,
                    spec=JobSpec(
                        tenant=str(rec.get("tenant", "default")),
                        workload="wordcount",
                        cfg=EngineConfig(),
                    ),
                    corpus_digest=str(rec.get("corpus_sha", "")),
                    n_lines=0, n_blocks=1, bucket=1,
                )
                ghost.error = structured_error(
                    "dispatch_failed",
                    f"journal admit record unusable after restart "
                    f"({type(e).__name__}: {e}) — resubmit",
                )
                ghost.finished_s = now
                ghost.state = "failed"
                with self._lock:
                    self._remember(ghost)
                self.journal.append_state(
                    job_id, "failed", error=ghost.error
                )
                failed += 1
                continue
            if term is not None and term["state"] in ("failed", "cancelled"):
                job.state = term["state"]
                # Fallback code keyed by the terminal STATE: an old
                # record with no error payload must not rewrite a
                # cancellation into a dispatch failure — clients switch
                # on .code (docs/SERVING.md).
                job.error = dict(term.get("error") or structured_error(
                    "cancelled" if term["state"] == "cancelled"
                    else "dispatch_failed",
                    f"{term['state']} before the restart",
                ))
                job.finished_s = now
                with self._lock:
                    self._remember(job)
                restored += 1
                continue
            if term is not None and term["state"] == "done":
                hit = self.results.get_with_meta(
                    job.corpus_digest, spec.fingerprint()
                )
                if hit is not None:
                    pairs, meta = hit
                    job.state = "done"
                    job.cache = "result"
                    job.started_s = job.submitted_s
                    job.finished_s = now
                    job.result = pairs
                    job.result_bytes = jobs_pairs_bytes(pairs)
                    job.distinct = int(meta.get("distinct", len(pairs)))
                    job.truncated = bool(meta.get("truncated", False))
                    job.overflow_tokens = int(
                        meta.get("overflow_tokens", 0)
                    )
                    with self._lock:
                        self._result_bytes += job.result_bytes
                        self._remember(job)
                    restored += 1
                    continue
                # done but not persisted: fall through and recompute.
            corpus = self.journal.read_spill(job.corpus_digest)
            if corpus is None:
                job.error = structured_error(
                    "dispatch_failed",
                    "corpus spill missing or damaged after restart — "
                    "resubmit",
                )
                job.finished_s = now
                job.state = "failed"
                with self._lock:
                    self._remember(job)
                # Terminal record so compaction retires the admit — the
                # spill is gone, so every future replay would fail the
                # same way forever.
                self.journal.append_state(
                    job.job_id, "failed", error=job.error
                )
                failed += 1
                continue
            with self._lock:
                self._remember(job)
                self._corpus_put(job.job_id, corpus)
                if entry.stages and job.spec.plan is not None:
                    # Stage-progress records (distributed plans): the
                    # coordinator re-verifies each recorded partition
                    # file by sha and reuses the survivors instead of
                    # remapping the whole plan (docs/PLAN.md).
                    self._plan_progress[job.job_id] = list(entry.stages)
            self.scheduler.requeue(job, 0.0)
            if entry.terminal is not None:
                # A done-but-unpersisted job re-enqueues past its own
                # terminal record: a fresh admit append re-asserts
                # liveness (both compact and replay treat the LAST
                # record sequence as truth), otherwise compaction would
                # retire it mid-rerun and a second crash would lose it.
                self.journal.append_admit(job, corpus)
            requeued += 1
        self.journal.compact()
        if requeued or restored or failed or dropped:
            obs.event(
                "serve.replay",
                requeued=requeued, restored=restored,
                failed=failed, dropped=dropped,
            )
            logger.info(
                "journal replay: %d job(s) re-enqueued, %d restored "
                "finished, %d failed structured, %d dropped",
                requeued, restored, failed, dropped,
            )
