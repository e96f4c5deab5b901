"""Locust Serve on the card: the persistent multi-tenant engine daemon.

The port's single-node copy of the JAX package's ``serve/daemon.py``.
The one-shot CLI pays process start on every run (torch's import and a
CUDA context are most of a small job's wall, PERF.md section 5); this
daemon keeps ONE process resident, with warm engines on the daemon's
device (docs/SERVING.md):

  * **protocol**: the distributor's authenticated length-prefixed frames
    (distributor/protocol.py — HMAC, replay guard), with the serve
    command set::

        submit | status | result | cancel | invalidate | stats
        | ping | shutdown    (+ promote and the ship commands, refused)

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

Single node only: the worker pool, large-job sharding, distributed plans
and high availability (``workers``, ``ship_to``, ``standby_of``) refuse
at construction — they are the serve slice 10 (ROADMAP.md queue 1 item
8).  Without them the JAX daemon behaves exactly as this one: every
batch folds on the local engine and the daemon is always the primary.

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
import contextlib
import dataclasses
import hashlib
import logging
import os
import socket
import threading
import time
import uuid

from locust_tpu_torch import obs
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.distributor import protocol
from locust_tpu_torch.plan import PlanError
from locust_tpu_torch.serve import batch as batching
from locust_tpu_torch.serve.cache import (
    ExecutableCache,
    ResultCache,
    SubPlanCache,
    WarmState,
)
from locust_tpu_torch.serve.jobs import (
    WORKLOADS,
    Job,
    JobSpec,
    parse_spec,
    structured_error,
)
from locust_tpu_torch.serve.jobs import pairs_bytes as jobs_pairs_bytes
from locust_tpu_torch.serve.journal import JobJournal
from locust_tpu_torch.serve.scheduler import AdmitReject, FairScheduler
from locust_tpu_torch.utils import faultplan

logger = logging.getLogger("locust_tpu_torch")

# Where the scale-out and high-availability half of the serve tier waits.
SLICE_10 = "ROADMAP.md queue 1 item 8, the serve slice 10"

# The JAX daemon's command set, so a client of either package gets the
# same answers: promote and the ship commands are answered with the
# structured refusals of a JAX daemon that runs without HA.
SERVE_COMMANDS = (
    "ping", "submit", "status", "result", "cancel", "invalidate",
    "stats", "shutdown",
    "promote", "ship", "ship_catchup", "ship_spill",
)

# The fencing epoch file of a journal dir (the JAX serve/replicate.py
# EPOCH_FILE); read for the stats' replication sub-dict.
EPOCH_FILE = "epoch"


def _load_epoch(journal_dir: str) -> int:
    """The persisted fencing epoch (>= 1); a fresh or damaged file reads
    as 1, as in JAX."""
    try:
        with open(os.path.join(journal_dir, EPOCH_FILE),
                  encoding="utf-8") as f:
            return max(1, int(f.read().strip()))
    except (OSError, ValueError):
        return 1


@dataclasses.dataclass
class ServeConfig:
    """Daemon capacity/policy knobs: the JAX class's fields and defaults
    (docs/SERVING.md).  ``workers``, ``ship_to`` and ``standby_of``
    refuse at construction until the serve slice 10 lands; the other
    pool and HA fields are kept so a configuration spelled for the JAX
    daemon constructs here unchanged."""

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
    # Scale-out dispatch and HA: the serve slice 10.  Only the empty
    # defaults are accepted here.
    workers: tuple = ()
    pool_inflight: int = 1
    pool_rpc_timeout: float = 600.0
    pool_spill_dir: str | None = None
    shard_min_blocks: int = 64
    shard_max: int = 4
    plan_speculate_s: float = 30.0
    ship_to: str | None = None
    standby_of: str | None = None
    lease_s: float | None = None
    ship_heartbeat_s: float = 2.0

    def __post_init__(self):
        asked = [name for name in ("workers", "ship_to", "standby_of")
                 if getattr(self, name)]
        if asked:
            raise NotImplementedError(
                f"ServeConfig({', '.join(asked)}=...): the serve worker "
                "pool, sharding, distributed plans and high availability "
                f"are not ported yet ({SLICE_10}); run the daemon single-node"
            )


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
        self.cfg = cfg or ServeConfig()
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
        self.epoch = (
            _load_epoch(self.cfg.journal_dir)
            if self.journal is not None else 1
        )
        self._lock = threading.Lock()
        # The node has ONE card: every device touch — engine builds,
        # staging, folds and the demux's device->host reads — runs on
        # the dispatcher thread under this lock.
        self._engine_lock = threading.Lock()
        self._jobs: dict[str, Job] = {}       # insertion order = age
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
        if self.journal is not None:
            self._replay_journal()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatch", daemon=True
        )
        self._dispatcher.start()

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
                self.journal.compact()
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
            # The JAX daemon's answer when it is already the primary,
            # which a daemon without HA always is.
            return structured_error(
                "bad_spec",
                f"promote refused: this daemon is already the primary "
                f"(epoch {self.epoch})",
            )
        if cmd in protocol.SHIP_COMMANDS:
            return self._cmd_ship()
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

    def _cmd_ship(self) -> dict:
        """Replication frames: a daemon without a journal answers the
        JAX daemon's refusal; one with a journal refuses to act as a
        standby until replication is ported."""
        if self.journal is None:
            return structured_error(
                "bad_spec",
                "this daemon has no journal; start it with --journal-dir "
                "to receive replication",
            )
        return structured_error(
            "bad_spec",
            f"this daemon does not receive replication: high "
            f"availability is not ported yet ({SLICE_10})",
        )

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
        return {
            "status": "ok",
            "service": "locust-serve",
            "uptime_s": round(time.monotonic() - self._started_s, 3),
            "completed": completed,
            "jobs_by_state": states,
            "queued_corpus_bytes": corpus_total,
            "history_result_bytes": result_bytes,
            "queue": self.scheduler.stats(),
            "pool": None,
            "exec_cache": self.executables.stats(),
            "result_cache": self.results.stats(),
            "subplan_cache": self.subplans.stats(),
            "warm": self.warm.stats() if self.warm is not None else None,
            "journal": (
                self.journal.stats() if self.journal is not None else None
            ),
            "replication": self._replication_stats(),
        }

    def _replication_stats(self) -> dict:
        """The JAX daemon's replication sub-dict for a primary that
        ships nowhere: with a journal it carries the standby-side
        counters of a receiver that has applied nothing."""
        out = {
            "role": "primary",
            "epoch": self.epoch,
            "seen_epoch": self.epoch,
            "fenced_by": None,
            "primary_hint": None,
            "lease_s": self.cfg.lease_s,
        }
        if self.journal is not None:
            out["standby"] = {
                "applied_seq": 0,
                "applied_records": 0,
                "resyncs_answered": 0,
                "catchups": 0,
                "missing_spills": 0,
                "primary": None,
                "contact_age_s": round(
                    time.monotonic() - self._started_s, 3
                ),
            }
        return out

    # ----------------------------------------------------------- dispatch

    def _batch_key(self, job: Job):
        # bisect_group keeps the halves of a failed batch from
        # re-coalescing (jobs.Job.bisect_group).  The engine_key half
        # folds the PLAN fingerprint in for plan jobs, and plan jobs
        # dispatch solo: a compiled plan runs one corpus end-to-end.
        key = (
            self.executables.engine_key(job.spec), job.bucket,
            job.bisect_group,
        )
        if job.spec.plan is not None:
            return key + (("solo", job.job_id),)
        return key

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
        self._sweep_deadlines()
        # Only an occupied queue is worth a queue-wait span: an idle
        # daemon's poll ticks would bury the timeline in no-op spans.
        cm = (
            obs.span("serve.queue_wait")
            if self.scheduler.depth()
            else contextlib.nullcontext()
        )
        with cm:
            batches = self.scheduler.next_batches(
                self._batch_key, max_batches=1,
                timeout=self.cfg.dispatch_poll_s,
            )
        if not batches:
            return
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
            self._dispatch_local(jobs, corpora)
        self._maybe_mark_warm()
        if self.journal is not None and self.journal.compact_due():
            self.journal.compact()

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
        """One batch on the daemon's own engine, on its device."""
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

    def _finish_job(
        self, job: Job, pairs: list, distinct, truncated, overflow,
        cache_label: str, done: float,
    ) -> None:
        """Publish one finished job (host pairs only) — the demux core
        of the WordCount and plan paths."""
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
        with self._lock:
            # state flips to "done" LAST: status/result handlers read
            # job fields without this lock, so the state write is the
            # publish barrier — a reader seeing "done" must also see the
            # result (done-with-None-result would answer an empty pairs
            # list as success).
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
        if not job.spec.no_cache:
            self.results.put(
                job.corpus_digest, job.spec.fingerprint(), pairs,
                meta=meta,
            )
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
