"""High-availability control plane: WAL shipping to a hot standby.

The port's copy of the JAX package's ``serve/replicate.py``: the same
frames, records, epoch file and fencing replies, so a primary of either
package ships to a standby of either.  The journal makes acked jobs
survive *process* death and the worker pool makes dispatch survive
*worker* death; this module extends "never lost work" to the daemon's
MACHINE dying (docs/SERVING.md
"High availability") — Dean & Ghemawat's re-execution thesis applied to
the control plane, with the fencing discipline of primary-backup
replicated logs so a partition can never produce two daemons answering
for the same jobs:

  * **shipping** (``ReplicationShipper``, primary side): every record
    the journal durably appends is enqueued (``JobJournal.on_append``)
    and shipped to the standby over the distributor's authenticated
    frame protocol — sequence-numbered, checksummed, acked.  Shipping is
    ASYNCHRONOUS off the admit path: a dead or slow standby degrades to
    a logged warning plus a lag gauge (``serve.ship_lag``), never a slow
    or failed admit.  Corpus spills ship by sha REFERENCE; the standby
    pulls missing bytes on demand (``ship_spill``).
  * **catch-up**: a standby that connects late, falls behind (queue
    overflow), or detects a sequence gap converges through a full
    live-journal snapshot (``ship_catchup``) taken atomically under the
    journal lock.  The primary's journal COMPACTION ships as the same
    snapshot barrier — a standby mid-catch-up can race a compaction's
    spill GC and still converge, because every GC'd spill belongs to a
    job whose terminal record is already in the ship stream.
  * **application** (``ShipReceiver``, standby side): records append
    into the standby's OWN journal (admits fsync'd — the standby's copy
    is what promotion replays), verbatim and in order.  A checksum
    mismatch (the ``serve.ship`` "corrupt" chaos action) is NEVER
    applied: the standby answers resync and the primary re-snapshots.
  * **fencing** (``load_epoch``/``store_epoch``/``stale_reply``): every
    shipped frame and every pool-worker RPC carries the sender's
    promotion epoch (``protocol.EPOCH_KEY``).  Promotion bumps the
    epoch and persists it; receivers reject lower epochs with the
    structured ``stale_epoch`` code — a zombie primary's first ship
    after a partition is refused, and it demotes itself to standby
    instead of split-braining.

torch-free at import, like the rest of the serve control plane.
"""

from __future__ import annotations

import base64
import collections
import hashlib
import json
import logging
import os
import socket
import threading
import time

from locust_tpu_torch import obs
from locust_tpu_torch.distributor import protocol
from locust_tpu_torch.serve.jobs import structured_error
from locust_tpu_torch.utils import faultplan

logger = logging.getLogger("locust_tpu_torch")

EPOCH_FILE = "epoch"

SHIP_BATCH_MAX = 64      # records per ship frame
SHIP_QUEUE_MAX = 4096    # queued records before a forced snapshot resync
SHIP_CONNECT_TIMEOUT = 5.0
SHIP_RPC_TIMEOUT = 30.0
SHIP_BACKOFF_MAX_S = 5.0


def load_epoch(journal_dir: str) -> int:
    """The persisted fencing epoch (>= 1).  A fresh journal dir starts
    at epoch 1; damage reads as 1 — the first PROMOTION anywhere in the
    pair bumps past it, so a lost epoch file can only make this daemon
    easier to fence, never harder."""
    try:
        with open(os.path.join(journal_dir, EPOCH_FILE),
                  encoding="utf-8") as f:
            return max(1, int(f.read().strip()))
    except (OSError, ValueError):
        return 1


def store_epoch(journal_dir: str, epoch: int) -> None:
    """Durably persist the fencing epoch (tmp + atomic rename + fsync):
    a promoted standby that restarts must come back ABOVE the zombie it
    fenced, or the fence would evaporate with the process."""
    path = os.path.join(journal_dir, EPOCH_FILE)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(str(int(epoch)))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def stale_reply(epoch: int, primary: str | None) -> dict:
    """The ONE shape every fencing rejection takes: the structured
    ``stale_epoch`` code plus the rejecting side's epoch (so the fenced
    sender can persist what it must now exceed) and, when known, the
    address the sender should treat as primary."""
    reply = structured_error(
        "stale_epoch",
        f"fencing epoch is behind this daemon's epoch {epoch}; a newer "
        "primary owns these jobs — demote to standby",
    )
    reply["epoch"] = int(epoch)
    if primary:
        reply["primary"] = primary
    return reply


def records_blob(records: list[dict]) -> tuple[str, str]:
    """Serialize a record batch for the wire: (canonical JSON text, its
    sha256).  The checksum is computed BEFORE the ``serve.ship``
    "corrupt" chaos action can touch the text, so rot between the
    journal and the frame — inside the HMAC boundary — is detected by
    the standby and the record is never applied."""
    text = json.dumps(records, sort_keys=True, separators=(",", ":"))
    return text, hashlib.sha256(text.encode()).hexdigest()


def decode_blob(text: str, checksum: str) -> list[dict] | None:
    """Verify + parse a shipped record batch; None = corrupt (the
    caller answers resync and applies NOTHING)."""
    if hashlib.sha256(text.encode("utf-8", "replace")).hexdigest() \
            != checksum:
        return None
    try:
        records = json.loads(text)
    except ValueError:
        return None
    if not isinstance(records, list) or not all(
        isinstance(r, dict) for r in records
    ):
        return None
    return records


class ReplicationShipper:
    """Primary-side WAL shipping thread.

    One persistent authenticated connection to the standby; records
    enqueue from the journal's append path (handler threads + the
    dispatcher) and drain here.  All shared state mutates under one
    condition variable (R001); every blocking wait is bounded (R013)
    and the thread is daemonized AND joined, bounded, in ``stop()``
    (R012).
    """

    def __init__(
        self,
        target: tuple[str, int],
        secret: bytes,
        journal,
        epoch_fn,
        advertise: str,
        on_fenced=None,
        heartbeat_s: float = 2.0,
    ):
        self.target = (str(target[0]), int(target[1]))
        self.name = f"{self.target[0]}:{self.target[1]}"
        self.secret = secret
        self.journal = journal
        self._epoch_fn = epoch_fn      # () -> current fencing epoch
        self._advertise = advertise    # this primary's "host:port"
        self._on_fenced = on_fenced    # (higher_epoch, primary|None) -> None
        self._heartbeat_s = max(0.2, float(heartbeat_s))
        self._cond = threading.Condition()
        self._records: collections.deque = collections.deque()
        self._seq = 0              # last seq ENQUEUED
        self._acked_seq = 0        # last seq the standby confirmed applied
        self._lag_bytes = 0        # serialized bytes of queued records
        self._need_catchup = True  # first contact always snapshots
        self._connected = False
        self._last_contact_t: float | None = None
        self._last_catchup_t: float | None = None
        self._ship_errors = 0
        self._resyncs = 0
        self._drops = 0            # records discarded to queue overflow
        self._enqueues = 0         # admit-path cost accounting: the
        self._enqueue_ms = 0.0     # synchronous part shipping adds
        self._stop = threading.Event()
        self._conn: socket.socket | None = None
        self._thread = threading.Thread(
            target=self._run, name="serve-ship", daemon=True
        )

    # -------------------------------------------------------------- intake

    def start(self) -> None:
        self._thread.start()

    def enqueue(self, rec: dict) -> None:
        """``JobJournal.on_append`` callback: O(1), lock-bounded, never
        raises — the admit path must not observe the standby's health.
        Its wall cost is accounted (``stats().enqueue_ms_mean``): this
        is the ONLY synchronous cost shipping adds to an admit, and the
        bench recovery sub-dict pins it under 5% of admit latency."""
        t0 = time.perf_counter()
        size = len(json.dumps(rec, separators=(",", ":")))
        with self._cond:
            self._seq += 1
            if len(self._records) >= SHIP_QUEUE_MAX:
                # Overflow: drop the whole backlog and resync through a
                # snapshot — bounded memory beats a faithful-but-
                # unbounded queue, and the snapshot is exactly as
                # convergent.
                self._drops += len(self._records)
                self._records.clear()
                self._lag_bytes = 0
                self._need_catchup = True
            self._records.append((self._seq, rec))
            self._lag_bytes += size
            self._enqueues += 1
            self._enqueue_ms += (time.perf_counter() - t0) * 1e3
            self._cond.notify_all()

    def barrier(self) -> None:
        """Journal-compaction barrier: the next ship is a full snapshot,
        so the standby compacts to the same live set and can never be
        stranded chasing spills the primary's GC removed."""
        with self._cond:
            self._need_catchup = True
            self._cond.notify_all()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if threading.current_thread() is not self._thread:
            # The fenced path calls stop() FROM the shipping thread
            # (on_fenced -> daemon demote -> here): it is already past
            # its loop and about to return, so only a foreign caller
            # needs the bounded join.
            self._thread.join(timeout=timeout)
        with self._cond:
            conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def lag(self) -> int:
        with self._cond:
            return self._seq - self._acked_seq

    def stats(self) -> dict:
        with self._cond:
            return {
                "standby": self.name,
                "connected": self._connected,
                "shipped_seq": self._seq,
                "acked_seq": self._acked_seq,
                "lag_records": self._seq - self._acked_seq,
                "lag_bytes": self._lag_bytes,
                "ship_errors": self._ship_errors,
                "resyncs": self._resyncs,
                "dropped_records": self._drops,
                "enqueue_ms_mean": round(
                    self._enqueue_ms / self._enqueues, 5
                ) if self._enqueues else None,
                "last_contact_t": self._last_contact_t,
                "last_catchup_t": self._last_catchup_t,
            }

    # ------------------------------------------------------------ transport

    def _rpc(self, req: dict) -> dict:
        """One request/reply on the persistent standby connection.
        Bounded everywhere: connect and per-frame socket timeouts."""
        with self._cond:
            conn = self._conn
        if conn is None:
            faultplan.check_connect(self.target[0], self.target[1])
            conn = socket.create_connection(
                self.target, timeout=SHIP_CONNECT_TIMEOUT
            )
            with self._cond:
                self._conn = conn
        try:
            conn.settimeout(SHIP_RPC_TIMEOUT)
            protocol.send_frame(conn, req, self.secret)
            return protocol.recv_frame(conn, self.secret)
        except Exception:
            self._drop_conn()
            raise

    def _drop_conn(self) -> None:
        with self._cond:
            conn, self._conn = self._conn, None
            self._connected = False
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    # -------------------------------------------------------------- loop

    def _run(self) -> None:
        backoff = 0.2
        warned = False
        while not self._stop.is_set():
            with self._cond:
                due = (
                    self._records
                    or self._need_catchup
                    or self._last_contact_t is None
                    or time.monotonic() - self._last_contact_t
                    >= self._heartbeat_s
                )
                if not due:
                    self._cond.wait(timeout=self._heartbeat_s / 2.0)
                    continue
            if self._stop.is_set():
                break
            try:
                self._ship_once()
                backoff = 0.2
                if warned:
                    logger.info(
                        "replication to standby %s recovered", self.name
                    )
                    warned = False
            except _Fenced as e:
                logger.warning(
                    "replication fenced by epoch %d (primary %s) — "
                    "demoting", e.epoch, e.primary or "unknown",
                )
                if self._on_fenced is not None:
                    self._on_fenced(e.epoch, e.primary)
                return  # the demoted daemon stops this shipper
            except Exception as e:  # noqa: BLE001 - a dead standby must
                # never hurt the primary: log once per outage, back off,
                # let lag accrue (the stats/lag gauge is the operator
                # signal).
                with self._cond:
                    self._ship_errors += 1
                    self._need_catchup = True
                if not warned:
                    logger.warning(
                        "replication to standby %s failing (%s: %s); "
                        "admits are unaffected, lag will accrue",
                        self.name, type(e).__name__, e,
                    )
                    warned = True
                self._stop.wait(timeout=backoff)
                backoff = min(backoff * 2.0, SHIP_BACKOFF_MAX_S)
        self._drop_conn()

    def _mark_contact(self, acked_seq=None, catchup: bool = False) -> None:
        with self._cond:
            self._connected = True
            self._last_contact_t = time.monotonic()
            if catchup:
                self._last_catchup_t = time.time()
            if acked_seq is not None:
                self._acked_seq = max(self._acked_seq, int(acked_seq))
            lag = self._seq - self._acked_seq
        obs.metric_set("serve.ship_lag", lag)

    def _chaos(self, cmd: str, seq: int, n: int, text: str):
        """The ``serve.ship`` site: (possibly mangled text, dropped?).
        Fires AFTER the snapshot/batch is final and its checksum is
        computed — the standby's integrity check is what keeps a
        corrupt record from ever being applied."""
        rule = faultplan.fire("serve.ship", cmd=cmd, seq=seq, n=n)
        if rule is None:
            return text, False
        if rule.action == "delay":
            time.sleep(rule.delay_s)
            return text, False
        if rule.action == "drop":
            return text, True
        plan = faultplan.active()
        mangled = plan.mutate(rule, text.encode())
        return mangled.decode("utf-8", "replace"), False

    def _chaos_spill(self, sha: str, data):
        """The ``serve.ship`` site on the SPILL path (cmd="spill"):
        (possibly mangled bytes, dropped?).  A mangled spill fails the
        standby's verify-then-write sha check (journal.store_spill), so
        it stays in ``need_spills`` and is re-asked on the next ship —
        corruption converges through re-request, never a bad write."""
        rule = faultplan.fire("serve.ship", cmd="spill", sha=sha, n=1)
        if rule is None:
            return data, False
        if rule.action == "delay":
            time.sleep(rule.delay_s)
            return data, False
        if rule.action == "drop":
            return data, True
        if data is None:
            return data, False
        plan = faultplan.active()
        return plan.mutate(rule, data), False

    def _ship_once(self) -> None:
        if self._catchup_due():
            self._catchup()
        while not self._stop.is_set():
            with self._cond:
                if self._need_catchup:
                    return  # a resync was requested mid-stream
                batch = []
                size = 0
                while self._records and len(batch) < SHIP_BATCH_MAX:
                    seq, rec = self._records.popleft()
                    batch.append((seq, rec))
                    size += len(json.dumps(rec, separators=(",", ":")))
                self._lag_bytes = max(0, self._lag_bytes - size)
            if not batch:
                with self._cond:
                    stale = (
                        self._last_contact_t is None
                        or time.monotonic() - self._last_contact_t
                        >= self._heartbeat_s
                    )
                    next_seq = self._seq + 1
                if stale:
                    # Heartbeat: an empty ship keeps the standby's lease
                    # fresh and collects the current ack.
                    self._send_ship(next_seq, [])
                return
            seq_from = batch[0][0]
            self._send_ship(seq_from, [rec for _, rec in batch])

    def _send_ship(self, seq_from: int, records: list[dict]) -> None:
        text, checksum = records_blob(records)
        text, dropped = self._chaos("ship", seq_from, len(records), text)
        if dropped:
            # The batch vanishes in flight: the next ship's sequence gap
            # makes the standby ask for a resync — convergence through
            # the snapshot, never silent divergence.
            return
        with obs.span("serve.ship", cmd="ship", n=len(records)):
            reply = self._rpc({
                "cmd": "ship",
                protocol.EPOCH_KEY: int(self._epoch_fn()),
                "from": self._advertise,
                "seq_from": int(seq_from),
                "records": text,
                "sum": checksum,
            })
        self._check_fenced(reply)
        if reply.get("status") != "ok":
            raise RuntimeError(f"standby answered: {reply.get('error')}")
        self._mark_contact(acked_seq=reply.get("acked_seq"))
        if reply.get("resync"):
            with self._cond:
                self._resyncs += 1
                self._need_catchup = True
            return
        self._send_spills(reply.get("need_spills") or ())

    def _catchup_due(self) -> bool:
        with self._cond:
            return self._need_catchup

    def _catchup(self) -> None:
        # Drain the incremental queue FIRST, then snapshot: anything
        # enqueued before the snapshot read is inside it (duplicates
        # with later enqueues are harmless — replay dedups by job id),
        # and the snapshot seq restarts the contiguous stream.
        with self._cond:
            self._records.clear()
            self._lag_bytes = 0
        records = self.journal.live_records()
        with self._cond:
            snapshot_seq = self._seq
        text, checksum = records_blob(records)
        text, dropped = self._chaos(
            "catchup", snapshot_seq, len(records), text
        )
        if dropped:
            return  # still flagged need_catchup: the next pass retries
        with obs.span("serve.ship", cmd="catchup", n=len(records)):
            reply = self._rpc({
                "cmd": "ship_catchup",
                protocol.EPOCH_KEY: int(self._epoch_fn()),
                "from": self._advertise,
                "seq": int(snapshot_seq),
                "records": text,
                "sum": checksum,
            })
        self._check_fenced(reply)
        if reply.get("status") != "ok":
            raise RuntimeError(f"standby answered: {reply.get('error')}")
        if reply.get("resync"):
            # The snapshot itself arrived damaged (chaos corrupt):
            # retry on the next pass, nothing was applied.
            with self._cond:
                self._resyncs += 1
            self._mark_contact()
            return
        self._send_spills(reply.get("need_spills") or ())
        self._mark_contact(acked_seq=reply.get("acked_seq"), catchup=True)
        with self._cond:
            self._need_catchup = False

    def _send_spills(self, shas) -> None:
        """On-demand spill transfer: the standby asked for corpus bytes
        it lacks.  A spill the primary's compaction already GC'd ships
        as ``gone`` — its job went terminal, and the terminal record
        (already in the stream, behind the snapshot the standby asked
        from) retires the job before promotion could miss the bytes."""
        for sha in shas:
            sha = str(sha)
            data = self.journal.read_spill(sha)
            data, dropped = self._chaos_spill(sha, data)
            if dropped:
                # In-flight loss must not be silent: raising sends _run
                # through its retry path (need_catchup + backoff), and
                # the standby re-asks for the sha it still lacks.
                raise RuntimeError(
                    f"spill {sha[:12]} dropped in flight; standby still "
                    "awaits it"
                )
            req = {
                "cmd": "ship_spill",
                protocol.EPOCH_KEY: int(self._epoch_fn()),
                "from": self._advertise,
                "sha": sha,
            }
            if data is None:
                req["gone"] = True
            else:
                req["data_b64"] = base64.b64encode(data).decode()
            with obs.span("serve.ship", cmd="spill", n=1):
                reply = self._rpc(req)
            self._check_fenced(reply)
            if reply.get("status") != "ok":
                raise RuntimeError(
                    f"standby refused spill {sha[:12]}: {reply.get('error')}"
                )

    def _check_fenced(self, reply: dict) -> None:
        if reply.get("code") == "stale_epoch":
            raise _Fenced(
                int(reply.get("epoch") or 0), reply.get("primary")
            )


class _Fenced(Exception):
    """A receiver rejected our epoch: a newer primary exists."""

    def __init__(self, epoch: int, primary: str | None):
        self.epoch = epoch
        self.primary = primary
        super().__init__(f"fenced by epoch {epoch}")


class ShipReceiver:
    """Standby-side record application (the daemon routes ship commands
    here after fencing).  Applies records into the standby's OWN journal
    — verbatim, in order, admits fsync'd — and tracks the sequence
    high-water mark for gap detection.  Thread-safe: connection handler
    threads apply concurrently in principle (one primary sends serially,
    but the lock keeps a reconnect race ordered)."""

    def __init__(self, journal):
        self.journal = journal
        self._lock = threading.Lock()
        self._applied_seq = 0
        self._applied_records = 0
        self._resyncs_answered = 0
        self._catchups = 0
        self._last_contact_t: float | None = None
        self._primary: str | None = None
        # Spill shas this standby has ASKED for but not yet received:
        # an applied admit is only failover-SAFE once its corpus bytes
        # landed too, so "replication caught up" for an operator (and
        # the drills) is lag == 0 AND missing_spills == 0 — the ship
        # ack alone leaves a window where a dying primary strands an
        # acked job on a spill still in flight.
        self._awaiting_spills: set[str] = set()

    # ------------------------------------------------------------ queries

    def primary(self) -> str | None:
        """The primary's advertised address, learned from ship traffic
        (fresher than any static seed after a chain of failovers)."""
        with self._lock:
            return self._primary

    def contact_age_s(self) -> float | None:
        with self._lock:
            if self._last_contact_t is None:
                return None
            return time.monotonic() - self._last_contact_t

    def touch(self) -> None:
        """Reset the lease clock (daemon start / promotion reversal)."""
        with self._lock:
            self._last_contact_t = time.monotonic()

    def stats(self) -> dict:
        with self._lock:
            return {
                "applied_seq": self._applied_seq,
                "applied_records": self._applied_records,
                "resyncs_answered": self._resyncs_answered,
                "catchups": self._catchups,
                "missing_spills": len(self._awaiting_spills),
                "primary": self._primary,
                "contact_age_s": (
                    round(time.monotonic() - self._last_contact_t, 3)
                    if self._last_contact_t is not None else None
                ),
            }

    # ----------------------------------------------------------- handlers

    def _note_contact(self, req: dict) -> None:
        with self._lock:
            self._last_contact_t = time.monotonic()
            if req.get("from"):
                self._primary = str(req["from"])

    def _missing_spills(self, records: list[dict]) -> list[str]:
        shas = []
        for rec in records:
            sha = str(rec.get("corpus_sha") or "")
            if (
                rec.get("rec") == "admit" and sha
                and not self.journal.spill_exists(sha)
                and sha not in shas
            ):
                shas.append(sha)
        with self._lock:
            self._awaiting_spills.update(shas)
        return shas

    def handle_ship(self, req: dict) -> dict:
        self._note_contact(req)
        records = decode_blob(
            str(req.get("records", "")), str(req.get("sum", ""))
        )
        with self._lock:
            acked = self._applied_seq
        if records is None:
            # Corrupt in flight (the serve.ship chaos contract): apply
            # NOTHING, ask the primary to resync through a snapshot.
            with self._lock:
                self._resyncs_answered += 1
            return {"status": "ok", "acked_seq": acked, "resync": True,
                    "why": "checksum"}
        seq_from = int(req.get("seq_from") or 0)
        if seq_from > acked + 1:
            # Gap: a dropped ship (or a primary restart's fresh seq
            # space).  Nothing is applied out of order — the snapshot
            # catch-up converges.  Checked BEFORE the heartbeat
            # early-return: a heartbeat carries seq_from = last+1, so a
            # drop followed by a quiescent stream is detected by the
            # very next heartbeat instead of never (the records the
            # standby missed may have been the last ones for hours).
            with self._lock:
                self._resyncs_answered += 1
            return {"status": "ok", "acked_seq": acked, "resync": True,
                    "why": "gap"}
        if not records:
            return {"status": "ok", "acked_seq": acked}  # heartbeat
        applied = 0
        for rec in records:
            if not self._valid_record(rec):
                with self._lock:
                    self._resyncs_answered += 1
                return {"status": "ok", "acked_seq": acked,
                        "resync": True, "why": "malformed"}
            self.journal.apply_record(rec)
            applied += 1
        with self._lock:
            self._applied_seq = max(
                self._applied_seq, seq_from + len(records) - 1
            )
            self._applied_records += applied
            acked = self._applied_seq
        return {
            "status": "ok",
            "acked_seq": acked,
            "need_spills": self._missing_spills(records),
        }

    def handle_catchup(self, req: dict) -> dict:
        self._note_contact(req)
        records = decode_blob(
            str(req.get("records", "")), str(req.get("sum", ""))
        )
        with self._lock:
            acked = self._applied_seq
        if records is None or not all(
            self._valid_record(r) for r in records
        ):
            with self._lock:
                self._resyncs_answered += 1
            return {"status": "ok", "acked_seq": acked, "resync": True,
                    "why": "checksum"}
        self.journal.reset_to(records)
        with self._lock:
            self._applied_seq = int(req.get("seq") or 0)
            self._applied_records += len(records)
            self._catchups += 1
            acked = self._applied_seq
            # The snapshot defines a fresh live universe: spill debts
            # from before the reset must not linger as phantom
            # missing_spills after their jobs were compacted away.
            self._awaiting_spills.clear()
        return {
            "status": "ok",
            "acked_seq": acked,
            "need_spills": self._missing_spills(records),
        }

    def handle_spill(self, req: dict) -> dict:
        self._note_contact(req)
        sha = str(req.get("sha") or "")
        if not sha:
            return structured_error("bad_spec", "ship_spill without a sha")
        if req.get("gone"):
            # The primary's compaction GC'd it: the job went terminal,
            # and its terminal record retires the admit before this
            # standby would ever need the bytes.  Log and move on — the
            # compaction-vs-catch-up race must not strand us.
            logger.info(
                "standby: spill %s is gone on the primary (job went "
                "terminal); continuing", sha[:12],
            )
            with self._lock:
                self._awaiting_spills.discard(sha)
            return {"status": "ok", "stored": False}
        try:
            data = base64.b64decode(str(req.get("data_b64", "")))
        except (ValueError, TypeError):
            return structured_error("bad_spec", "ship_spill bad payload")
        stored = self.journal.store_spill(sha, data)
        if stored:
            with self._lock:
                self._awaiting_spills.discard(sha)
        return {"status": "ok", "stored": stored}

    @staticmethod
    def _valid_record(rec: dict) -> bool:
        """Shape gate before a shipped record touches the standby's
        journal: the wire-level checksum already matched, so this only
        screens records a buggy (not corrupt) sender could form."""
        kind = rec.get("rec")
        if kind == "admit":
            return bool(rec.get("job_id"))
        if kind == "state":
            return bool(rec.get("job_id")) and isinstance(
                rec.get("state"), str
            )
        return False
