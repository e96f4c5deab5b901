"""Write-ahead job journal: accepted work survives a SIGKILL.

The port's copy of the JAX package's ``serve/journal.py``, with its
stage-progress records (distributed plans) and its replication hooks
(the apply, snapshot and reset a hot standby needs, serve/replicate.py).
The on-disk format is the JAX module's, so a journal written by either
package, stage records included, replays in the other (docs/SERVING.md):

  * **append-before-ack**: every admitted job appends one fsync'd JSONL
    record — tenant, workload, config overrides, deadline/retry budget,
    corpus sha256 — BEFORE the client's accept ack leaves the daemon.
    An acked job is therefore always replayable; a job lost in the
    append window was never acked, so the client retries.
  * **corpus spill**: the inline corpus bytes land content-addressed
    under ``<journal_dir>/corpus/<sha256>.bin`` (dedup'd across jobs and
    integrity-checked on read) so replay can re-stage the exact bytes.
  * **state records**: terminal transitions (done / failed / cancelled /
    rejected) append flush-only records — losing one costs a replayed
    RECOMPUTE (deterministic, byte-identical), never a wrong answer.
  * **replay**: ``replay()`` parses the journal tolerantly (a torn or
    corrupt line is skipped with a warning — that is what a crash
    mid-append leaves) and returns per-job admit records plus the last
    terminal state; the daemon re-enqueues unfinished jobs under their
    ORIGINAL ids and compacts the log.
  * **compaction**: ``compact()`` atomically rewrites the journal to
    just the still-live admit records (decided from the journal's own
    records under the lock that serializes appends and spills, so a
    concurrent admit is never dropped) and deletes unreferenced spills.

Chaos: the ``serve.journal`` site (utils/faultplan.py) fires inside the
append — "crash" writes a TORN record then raises (the submit is
rejected structured, never acked), "corrupt" mangles the record bytes
silently (replay must skip the line).  torch-free at import.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time

from locust_tpu_torch import obs
from locust_tpu_torch.utils import faultplan

logger = logging.getLogger("locust_tpu")

JOURNAL_FILE = "journal.jsonl"
CORPUS_DIR = "corpus"

# Journal format version: an old daemon's journal is replayed by a new
# one only when the record layout still matches; a skew is a loud warning
# and a skipped record, never a crash (same stance as the warm file).
JOURNAL_VERSION = 1

# Terminal states a "state" record may carry.  "rejected" is journal-only
# (an admit that scheduler admission then refused — replay must not
# resurrect it); the rest mirror jobs.JOB_STATES terminals.
TERMINAL_STATES = ("done", "failed", "cancelled", "rejected")


def admit_record(job) -> dict:
    """The ONE admit-record shape, shared by the append path and the
    daemon's compaction (which rebuilds live records from its in-memory
    jobs) — two spellings of the record would drift."""
    spec = job.spec
    rec = {
        "rec": "admit",
        "v": JOURNAL_VERSION,
        "job_id": job.job_id,
        "tenant": spec.tenant,
        "workload": spec.workload,
        "config": dict(job.config_overrides or {}),
        "weight": spec.weight,
        "no_cache": spec.no_cache,
        "deadline_s": spec.deadline_s,
        "max_attempts": spec.max_attempts,
        "corpus_sha": job.corpus_digest,
        "n_lines": job.n_lines,
        "t": time.time(),
    }
    if spec.plan is not None:
        # Plan jobs journal the WHOLE plan document (docs/PLAN.md): the
        # WAL is what makes the accept ack a durable promise, and for an
        # arbitrary pipeline the plan IS the half of the work the corpus
        # spill does not carry — replay re-validates and re-executes it
        # under the original id.  Additive: pre-plan records simply lack
        # the key and replay exactly as before.
        rec["plan"] = json.loads(spec.plan)
    return rec


class JournalEntry:
    """One replayable job: its admit record + last terminal state +
    any distributed-plan stage-progress records (docs/PLAN.md
    "Distributed execution") journaled before the crash."""

    __slots__ = ("admit", "terminal", "stages")

    def __init__(self, admit: dict, terminal: dict | None = None):
        self.admit = admit
        self.terminal = terminal
        self.stages: list[dict] = []


class JobJournal:
    """Append-only JSONL write-ahead log + content-addressed corpus spill.

    Thread-safe: handler threads append admits, the dispatcher appends
    state records and compacts; one lock serializes the file.  Append
    latency is accounted (``serve.journal_ms`` histogram + ``stats()``)
    because the admit-path fsync is the one cost durability adds to the
    accept ack — the bench "recovery" sub-dict pins it under 5% of admit
    latency.
    """

    def __init__(self, journal_dir: str, fsync: bool = True,
                 compact_every: int = 512):
        self.dir = journal_dir
        self.fsync = fsync
        # Replication hook (serve/replicate.py, docs/SERVING.md "High
        # availability"): called with every record dict AFTER it landed
        # durably (never for a torn/failed append — an unacked record
        # must not reach the standby).  Set by the daemon; must be fast
        # and non-raising (it only enqueues on the async shipper).
        self.on_append = None
        self.compact_every = max(1, int(compact_every))
        self._corpus_dir = os.path.join(journal_dir, CORPUS_DIR)
        os.makedirs(self._corpus_dir, exist_ok=True)
        self.path = os.path.join(journal_dir, JOURNAL_FILE)
        # Reentrant: append_admit holds it across spill + record so
        # compaction's GC can never see (and sweep) a spill whose admit
        # record has not landed yet.
        self._lock = threading.RLock()
        self._fh = open(self.path, "ab")
        # A journal inherited from a crash may end mid-line (a torn
        # append): the next append must start on a fresh line or the
        # first post-restart record glues onto the debris and parses as
        # garbage — losing a perfectly good record to someone else's
        # torn write.
        try:
            size = os.path.getsize(self.path)
            if size:
                with open(self.path, "rb") as f:
                    f.seek(size - 1)
                    self._dirty_tail = f.read(1) != b"\n"
            else:
                self._dirty_tail = False
        except OSError:  # pragma: no cover - defensive
            self._dirty_tail = True
        self._appends_since_compact = 0
        self._appends = 0
        self._append_ms = 0.0
        self._spills = 0
        self._spill_ms = 0.0
        self._last_compact_t: float | None = None

    @property
    def corpus_dir(self) -> str:
        """The content-addressed spill directory.  The serve worker
        pool shares it (serve/pool.py): admitted corpora are already
        spilled here once, so a pool dispatch ships a reference, not
        bytes."""
        return self._corpus_dir

    # ------------------------------------------------------------- appends

    def append_admit(self, job, corpus: bytes) -> None:
        """Spill the corpus, then durably append the admit record.

        MUST complete before the accept ack: the record is what makes
        the ack a promise.  Raises on chaos crash or a real disk error —
        the caller rolls the admission back and answers structured.
        Spill and record costs are accounted separately (``stats()``):
        the record append is the O(1) per-admit WAL cost, the spill a
        corpus-proportional buffer write (dedup'd by sha, so repeat
        corpora pay it once).
        """
        with self._lock:
            # ONE lock hold across spill + record (reentrant lock): a
            # compaction between them would GC the not-yet-referenced
            # spill, turning this acked job's replay into a structured
            # spill-missing failure.
            t0 = time.perf_counter()
            self._spill(job.corpus_digest, corpus)
            self._spills += 1
            self._spill_ms += (time.perf_counter() - t0) * 1e3
            self._append(admit_record(job), durable=True)

    def append_state(self, job_id: str, state: str,
                     error: dict | None = None) -> None:
        """Flush-only terminal-state record (see module docstring for why
        these skip the fsync the admit record pays)."""
        if state not in TERMINAL_STATES:
            raise ValueError(f"not a terminal journal state: {state!r}")
        rec = {"rec": "state", "job_id": job_id, "state": state,
               "t": time.time()}
        if error is not None:
            rec["error"] = dict(error)
        self._append(rec, durable=False)

    def append_stage(self, job_id: str, stage: dict) -> None:
        """Flush-only stage-progress record for a distributed plan
        (docs/PLAN.md "Distributed execution"): one per completed map
        split, carrying its published partition references.  Replay
        hands them back so a restarted coordinator RESUMES from the
        splits whose partitions survived on disk instead of re-running
        the whole map wave.  Flush-only like state records: losing one
        to a crash only costs a recompute — the fsync'd admit record
        (which carries the whole plan) already guarantees the answer."""
        rec = {"rec": "stage", "job_id": job_id, "stage": dict(stage),
               "t": time.time()}
        self._append(rec, durable=False)

    def _append(self, rec: dict, durable: bool) -> None:
        data = (json.dumps(rec, separators=(",", ":")) + "\n").encode()
        rule = faultplan.fire(
            "serve.journal", rec=rec["rec"], job=rec.get("job_id")
        )
        torn = False
        if rule is not None:
            if rule.action == "corrupt":
                # Silent bit rot on the record: keep the trailing newline
                # so only THIS line is damaged — replay must skip it and
                # recover every other job.
                plan = faultplan.active()
                data = plan.mutate(rule, data[:-1]) + b"\n"
            else:  # crash: the daemon dies mid-append — a torn record
                data = data[: max(1, len(data) // 2)]
                torn = True
        t0 = time.perf_counter()
        with self._lock:
            try:
                if self._dirty_tail:
                    # Start fresh after a torn/failed write: gluing this
                    # record onto line debris would lose BOTH to replay.
                    self._fh.write(b"\n")
                    self._dirty_tail = False
                self._fh.write(data)
                self._fh.flush()
            except OSError:
                self._dirty_tail = True  # a short write may have landed
                raise
            if torn:
                self._dirty_tail = True
            if durable and self.fsync:
                os.fsync(self._fh.fileno())
            self._appends += 1
            self._appends_since_compact += 1
            self._append_ms += (time.perf_counter() - t0) * 1e3
        obs.metric_observe(
            "serve.journal_ms", (time.perf_counter() - t0) * 1e3
        )
        if torn:
            raise faultplan.FaultCrash(
                "[faultplan] injected journal crash mid-append "
                f"({rec['rec']} record torn)"
            )
        cb = self.on_append
        if cb is not None:
            # Outside the journal lock (the shipper has its own): the
            # record is durable locally by now, and per-job ordering is
            # safe — a terminal record is only ever generated after its
            # admit's append (and callback) returned.
            cb(rec)

    def apply_record(self, rec: dict) -> None:
        """Standby-side replication apply: append one SHIPPED record into
        this journal verbatim (serve/replicate.py).  Admit records pay
        the same fsync the primary paid — the standby's copy is what
        promotion replays, so it must be exactly as durable."""
        self._append(dict(rec), durable=rec.get("rec") == "admit")

    def compact_due(self) -> bool:
        with self._lock:
            return self._appends_since_compact >= self.compact_every

    # ------------------------------------------------------------- corpus

    def spill_path(self, sha: str) -> str:
        return os.path.join(self._corpus_dir, f"{sha}.bin")

    def _spill(self, sha: str, corpus: bytes) -> None:
        """Content-addressed, write-once: a sha already on disk is the
        same bytes by construction, so repeat submits of one corpus pay
        nothing.  tmp + rename so a crash never leaves a half spill
        under the final name (replay verifies the sha regardless).
        Holds the journal lock: compaction's spill GC runs under the
        same lock, so a spill landing mid-GC cannot be swept before the
        record that references it is appended."""
        path = self.spill_path(sha)
        with self._lock:
            if os.path.exists(path):
                return
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(corpus)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.replace(tmp, path)

    def spill_exists(self, sha: str) -> bool:
        return os.path.exists(self.spill_path(sha))

    def store_spill(self, sha: str, corpus: bytes) -> bool:
        """Replication-side spill store: verify-then-write (a shipped
        spill whose bytes don't hash to its sha reference must never
        land under that name — the content ADDRESS is the integrity
        contract).  False = rejected."""
        if hashlib.sha256(corpus).hexdigest() != sha:
            logger.warning(
                "shipped corpus spill %s fails its content hash; "
                "refusing to store it", sha,
            )
            return False
        with self._lock:
            self._spill(sha, corpus)
        return True

    def read_spill(self, sha: str) -> bytes | None:
        """The spilled corpus, integrity-checked; None when missing or
        damaged (the caller fails the job structured — a corrupt spill
        must never become a silently-wrong recompute)."""
        try:
            with open(self.spill_path(sha), "rb") as f:
                data = f.read()
        except OSError:
            return None
        if hashlib.sha256(data).hexdigest() != sha:
            logger.warning(
                "journal corpus spill %s fails its content hash; "
                "treating as lost", sha,
            )
            return None
        return data

    # ----------------------------------------------------- replay/compact

    def replay(self) -> list[JournalEntry]:
        """Parse the journal into per-job entries, admit order preserved.

        Tolerant by design: a torn/corrupt/version-skewed line is what a
        crash mid-append leaves, so it is skipped with a warning — every
        parseable job still replays (the chaos matrix pins this)."""
        entries: dict[str, JournalEntry] = {}
        skipped = 0
        try:
            with open(self.path, encoding="utf-8", errors="replace") as f:
                lines = f.readlines()
        except OSError:
            return []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                kind = rec["rec"]
                job_id = str(rec["job_id"])
                if kind == "admit":
                    if rec.get("v") != JOURNAL_VERSION:
                        raise ValueError(f"journal version {rec.get('v')!r}")
                    entries[job_id] = JournalEntry(rec)
                elif kind == "state":
                    if rec["state"] not in TERMINAL_STATES:
                        raise ValueError(f"bad state {rec['state']!r}")
                    if job_id in entries:
                        entries[job_id].terminal = rec
                elif kind == "stage":
                    if not isinstance(rec.get("stage"), dict):
                        raise ValueError("stage record without a stage")
                    if job_id in entries:
                        entries[job_id].stages.append(rec["stage"])
                else:
                    raise ValueError(f"unknown record type {kind!r}")
            except (ValueError, KeyError, TypeError) as e:
                skipped += 1
                logger.warning(
                    "journal record skipped (%s: %s): %.80r",
                    type(e).__name__, e, line,
                )
        if skipped:
            logger.warning(
                "journal replay skipped %d unparseable record(s) — "
                "jobs acked under them are lost to this restart", skipped,
            )
        return list(entries.values())

    def _parse_live(self, locked: bool = True) -> dict[str, dict]:
        """job_id -> admit record for every LIVE job (an admit with no
        later terminal state), journal order preserved.  With
        ``locked`` the caller holds the journal lock (the catch-up
        snapshot path, where atomicity is correctness); ``locked=False``
        is the informational stats read — the caller flushed already,
        and the tolerant parser handles whatever a concurrent
        append/compaction leaves.  Torn/corrupt lines are dropped
        exactly as replay would drop them."""
        if locked:
            self._fh.flush()
        admits: dict[str, dict] = {}
        try:
            with open(self.path, encoding="utf-8", errors="replace") as f:
                lines = f.readlines()
        except OSError:
            return {}
        for line in lines:
            text = line.strip()
            if not text:
                continue
            try:
                rec = json.loads(text)
                kind = rec["rec"]
                job_id = str(rec["job_id"])
                if kind == "admit":
                    admits[job_id] = rec
                elif kind == "state" and rec.get("state") in TERMINAL_STATES:
                    admits.pop(job_id, None)
            except (ValueError, KeyError, TypeError):
                continue
        return admits

    def live_records(self) -> list[dict]:
        """The catch-up snapshot (serve/replicate.py): every live admit
        record, read atomically under the journal lock so a concurrent
        append/compaction can never hand the standby a half state."""
        with self._lock:
            return list(self._parse_live().values())

    def reset_to(self, records: list[dict]) -> None:
        """Standby catch-up apply: atomically replace this journal's
        contents with exactly ``records`` (the primary's live snapshot)
        and GC spills nothing references anymore — the standby's
        equivalent of the primary's compaction, driven by the shipped
        snapshot barrier instead of a local liveness parse."""
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with self._lock:
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in records:
                    f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._fh.close()
            self._fh = open(self.path, "ab")
            self._dirty_tail = False
            self._appends_since_compact = 0
            keep = {str(r.get("corpus_sha", "")) for r in records}
            try:
                for name in os.listdir(self._corpus_dir):
                    sha = name[:-4] if name.endswith(".bin") else None
                    if sha is not None and sha not in keep:
                        os.unlink(os.path.join(self._corpus_dir, name))
            except OSError as e:  # pragma: no cover - GC is best-effort
                logger.warning("journal spill GC failed: %s", e)

    def compact(self) -> None:
        """Atomically rewrite the journal down to the LIVE jobs and GC
        unreferenced spills.  Liveness is decided from the journal's own
        records — a job is live iff it has an admit record and no
        terminal state record — computed and rewritten entirely under
        the one journal lock, which also serializes appends and spills:
        an admit fsync'd by a handler thread an instant before (or
        after) this call can therefore never be dropped, and a spill
        landing concurrently can never be swept (the race a
        daemon-snapshot-then-rewrite design would have).  Torn/corrupt
        lines are dropped — replay would skip them anyway.  A crash
        mid-compact leaves either the old or the new journal — tmp +
        ``os.replace``, the same publish protocol as snapshots."""
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with self._lock:
            self._fh.flush()
            try:
                with open(self.path, encoding="utf-8",
                          errors="replace") as f:
                    lines = f.readlines()
            except OSError:
                return
            admits: dict[str, str] = {}   # job_id -> raw admit line
            shas: dict[str, str] = {}     # job_id -> corpus sha
            for line in lines:
                text = line.strip()
                if not text:
                    continue
                try:
                    rec = json.loads(text)
                    kind = rec["rec"]
                    job_id = str(rec["job_id"])
                    if kind == "admit":
                        admits[job_id] = text
                        shas[job_id] = str(rec.get("corpus_sha", ""))
                    elif kind == "state" and rec.get("state") in \
                            TERMINAL_STATES:
                        admits.pop(job_id, None)
                        shas.pop(job_id, None)
                except (ValueError, KeyError, TypeError):
                    continue  # torn/corrupt: replay would skip it too
            with open(tmp, "w", encoding="utf-8") as f:
                for text in admits.values():
                    f.write(text + "\n")
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._fh.close()
            self._fh = open(self.path, "ab")
            self._dirty_tail = False  # the rewrite ends line-clean
            self._appends_since_compact = 0
            self._last_compact_t = time.time()
            keep_shas = set(shas.values())
            try:
                for name in os.listdir(self._corpus_dir):
                    sha = name[:-4] if name.endswith(".bin") else None
                    if sha is not None and sha not in keep_shas:
                        os.unlink(os.path.join(self._corpus_dir, name))
            except OSError as e:  # pragma: no cover - GC is best-effort
                logger.warning("journal spill GC failed: %s", e)

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.flush()
                self._fh.close()
            except OSError:  # pragma: no cover - closing is best-effort
                pass

    def spill_bytes(self) -> int:
        """Aggregate on-disk corpus-spill bytes (operator visibility —
        the journal stats sub-dict; best-effort under races with GC)."""
        total = 0
        try:
            for name in os.listdir(self._corpus_dir):
                if name.endswith(".bin"):
                    try:
                        total += os.path.getsize(
                            os.path.join(self._corpus_dir, name)
                        )
                    except OSError:
                        continue
        except OSError:
            pass
        return total

    def stats(self) -> dict:
        # The live parse + spill sweep run OUTSIDE the journal lock: a
        # monitoring loop polling stats must never stall the admit
        # path's fsync'd append on an O(journal) read.  Lock-free is
        # safe here — compaction publishes via atomic rename (a reader
        # sees the old or the new file, both parseable) and the
        # tolerant parser drops a torn tail exactly as replay would;
        # the count is informational, the CATCH-UP snapshot
        # (live_records) stays under the lock where atomicity is
        # correctness.
        with self._lock:
            try:
                self._fh.flush()
            except (OSError, ValueError):  # pragma: no cover - closing race
                pass
        live = len(self._parse_live(locked=False))
        spill_bytes = self.spill_bytes()
        with self._lock:
            return {
                "path": self.path,
                "appends": self._appends,
                "append_ms_total": round(self._append_ms, 3),
                "append_ms_mean": round(
                    self._append_ms / self._appends, 4
                ) if self._appends else None,
                "spills": self._spills,
                "spill_ms_mean": round(
                    self._spill_ms / self._spills, 4
                ) if self._spills else None,
                "since_compact": self._appends_since_compact,
                # HA operator surface (docs/SERVING.md): what a standby
                # would replay, how much disk the spills hold, and when
                # the log was last squeezed — readable from `serve
                # stats` without stalling admits.
                "live": live,
                "spill_bytes": spill_bytes,
                "last_compact_t": self._last_compact_t,
            }
