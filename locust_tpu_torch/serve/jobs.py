"""Job model for the serve tier: specs, runtime records, structured errors.

The port's copy of the JAX package's ``serve/jobs.py``.  A JOB is one
client-submitted corpus + pipeline configuration; the daemon
(serve/daemon.py) turns it into exactly one of two outcomes — a correct
result table or a STRUCTURED error carrying a reason code from the closed
``ERROR_CODES`` registry below (never a silent wrong answer,
docs/SERVING.md).  The registries, the spec validation and
``JobSpec.fingerprint()`` are the JAX module's, so result-cache keys, warm
files and journals agree across the two packages.  torch-free at import:
the scheduler and cache layers and the client import this without paying
for torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time

from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.plan import PlanError, from_doc as plan_from_doc

# Job lifecycle (reported verbatim by the ``status`` command):
#   queued -> running -> done | failed;  queued -> cancelled;
#   running -> retrying -> running (backoff requeue after a failed
#   dispatch, docs/SERVING.md retry ladder) until done | failed.
JOB_STATES = ("queued", "running", "retrying", "done", "failed", "cancelled")

# Closed reason-code registry for every structured error the daemon can
# hand a client (same closed-registry stance as faultplan.SITES and the
# obs NAMES dict): a client can switch on these without parsing prose.
ERROR_CODES = (
    "queue_full",        # admission control: the bounded queue is full
    "tenant_quota",      # admission control: per-tenant pending cap hit
    "shutting_down",     # daemon is stopping; do NOT retry this address
    "bad_spec",          # submit payload failed validation
    "unknown_workload",  # workload name not in WORKLOADS
    "corpus_too_large",  # inline corpus exceeds the daemon's cap
    "fault_injected",    # a serve.* chaos rule rejected/killed the job
    "dispatch_failed",   # the engine dispatch raised; message has detail
    "cancelled",         # the client cancelled the job while queued
    "unknown_job",       # status/result/cancel for an id we don't hold
    "not_done",          # result requested before the job finished
    "result_too_large",  # reply frame would exceed protocol.MAX_FRAME
    "unknown_command",   # command outside the serve command set
    "deadline_exceeded", # the job's deadline_s budget expired (any state)
    "poison_job",        # the job killed max_attempts dispatches; quarantined
    "journal_failed",    # WAL append failed; the accept ack would be a lie
    "not_primary",       # this daemon is a standby; reply names the primary
    "stale_epoch",       # sender's fencing epoch is behind; a newer primary rules
)

# Retry-budget guard rails: a submit may not ask for more attempts than
# the bisection ladder can meaningfully use (log2(max_batch) + retries),
# nor a deadline past what admission control can reason about.
MAX_ATTEMPTS_CAP = 16
DEADLINE_CAP_S = 3600.0

# workload name -> (map_fn import path resolved lazily in cache.py,
# combine).  Lazy: resolving here would pull torch into every importer.
# Only the name travels (wire, journal, fingerprint), so the path is the
# port's own map.
WORKLOADS = {
    "wordcount": ("locust_tpu_torch.ops.map_stage:wordcount_map", "sum"),
}

# Reserved workload name for plan-carrying jobs (docs/PLAN.md): a submit
# with a ``plan`` document runs an arbitrary compiled pipeline instead of
# a named WORKLOADS entry, and its executable identity is the PLAN
# fingerprint (+ config), not a workload string.  Deliberately NOT a
# WORKLOADS row — there is no single map_fn to resolve; every site that
# indexes WORKLOADS by name guards on ``spec.plan`` first.
PLAN_WORKLOAD = "plan"

# Engine-config fields a submit may override; everything else keeps the
# EngineConfig default.  A closed set so a typo'd knob is a loud
# ``bad_spec``, not a silently-ignored key.
SPEC_CONFIG_KEYS = (
    "line_width", "key_width", "emits_per_line", "block_lines",
    "table_size", "sort_mode",
)


def structured_error(code: str, message: str) -> dict:
    """The one shape every daemon-side failure reply takes."""
    if code not in ERROR_CODES:
        raise ValueError(f"unknown serve error code {code!r}")
    return {"status": "error", "code": code, "error": message}


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """What a client asked for: corpus + workload + pipeline config.

    ``fingerprint()`` identifies the EXECUTABLE the job needs (workload +
    full EngineConfig identity) — the result cache key adds the corpus
    digest on top, so "same program" and "same program over the same
    bytes" are distinct cache tiers (docs/SERVING.md).
    """

    tenant: str
    workload: str
    cfg: EngineConfig
    weight: float = 1.0
    invalidate: bool = False  # drop any cached result for this key first
    no_cache: bool = False    # compute fresh AND don't store the result
    # Durability/robustness budgets (docs/SERVING.md): deadline_s bounds
    # the job's whole submit->answer life (None = no deadline) —
    # expiry ANYWHERE (queued, running, retrying) answers the structured
    # ``deadline_exceeded`` code; max_attempts bounds how many dispatches
    # the job may kill before it is quarantined as ``poison_job``.  The
    # default of 4 lets the bisection ladder isolate a poison job out of
    # a full default batch (8 -> 4 -> 2 -> solo).  Neither is part of
    # ``fingerprint()``: budgets do not change the executable.
    deadline_s: float | None = None
    max_attempts: int = 4
    # Composable dataflow plan (docs/PLAN.md): the CANONICAL plan JSON
    # (``Plan.canonical_json()``, validated by parse_spec) for plan
    # jobs, None for named workloads.  A string, not a Plan: the frozen
    # spec stays hashable and journal-serializable, and the fingerprint
    # below hashes exactly these bytes.
    plan: str | None = None

    def plan_fingerprint(self) -> str | None:
        """The plan's content address — sha1 of the canonical JSON,
        identical by construction to ``Plan.fingerprint()`` (the spec
        stores canonical text, so no re-parse is needed)."""
        if self.plan is None:
            return None
        fp = self.__dict__.get("_plan_fp")
        if fp is None:
            fp = hashlib.sha1(self.plan.encode()).hexdigest()[:12]
            object.__setattr__(self, "_plan_fp", fp)
        return fp

    def fingerprint(self) -> str:
        # Memoized like EngineConfig.fingerprint(): the daemon asks at
        # submit, dispatch, demux and invalidate, and the spec is frozen.
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            if self.plan is not None:
                # Plan jobs: the executable IS the (plan, config) pair —
                # the plan fingerprint keys the result cache, warm
                # cache, shape buckets and batch keys (docs/PLAN.md).
                raw = (
                    f"{PLAN_WORKLOAD}:{self.plan_fingerprint()}:"
                    f"{self.cfg.fingerprint()}"
                )
            else:
                combine = WORKLOADS[self.workload][1]
                raw = f"{self.workload}:{combine}:{self.cfg.fingerprint()}"
            fp = hashlib.sha1(raw.encode()).hexdigest()[:12]
            object.__setattr__(self, "_fingerprint", fp)
        return fp


def parse_spec(
    req: dict, max_corpus_bytes: int | None = None
) -> tuple[JobSpec, bytes]:
    """Validate one ``submit`` request into (JobSpec, corpus bytes).

    Raises ``ValueError`` whose first line is an ERROR_CODES entry — the
    daemon maps it straight onto a structured reply.
    ``max_corpus_bytes`` bounds the path branch's read: the cap must
    hold BEFORE the bytes land in daemon memory, or a path submit
    naming a huge server-side file OOMs the daemon ahead of the
    rejection (inline corpus_b64 is already bounded by the frame cap).
    """
    plan_json = None
    raw_plan = req.get("plan")
    if raw_plan is not None:
        # A plan submit: validate the document end-to-end (structure,
        # registry membership, arity, cycles, dataflow types) BEFORE
        # anything is admitted — every malformation is a structured
        # bad_spec, never a dispatch-time surprise (docs/PLAN.md).
        if isinstance(raw_plan, str):
            try:
                raw_plan = json.loads(raw_plan)
            except ValueError as e:
                raise ValueError(f"bad_spec\nplan JSON does not parse: {e}")
        try:
            p = plan_from_doc(raw_plan)
        except PlanError as e:
            raise ValueError(f"bad_spec\ninvalid plan: {e}")
        # A serve submit carries ONE corpus: a plan whose sources name
        # distinct inputs would feed the same bytes to every source — a
        # silent self-join, the wrong answer this tier forbids.  Reject
        # at admission (run_corpus carries the dispatch-side defense).
        named = sorted({
            n.param("input", "corpus")
            for n in p.nodes if n.kind == "source"
        } - {"corpus"})
        if named:
            raise ValueError(
                f"bad_spec\nplan sources name inputs {named}, but a "
                "submit carries exactly one corpus (name every source "
                "input 'corpus' or split the pipeline)"
            )
        plan_json = p.canonical_json()
        if req.get("workload") not in (None, PLAN_WORKLOAD):
            raise ValueError(
                "bad_spec\nsubmit takes a plan OR a workload name, "
                "not both"
            )
        workload = PLAN_WORKLOAD
    else:
        workload = req.get("workload", "wordcount")
        if workload not in WORKLOADS:
            raise ValueError(
                f"unknown_workload\nworkload {workload!r} not in "
                f"{sorted(WORKLOADS)}"
            )
    corpus_b64 = req.get("corpus_b64")
    path = req.get("path")
    if (corpus_b64 is None) == (path is None):
        raise ValueError(
            "bad_spec\nsubmit needs exactly one of corpus_b64 or path"
        )
    if corpus_b64 is not None:
        import base64
        import binascii

        try:
            corpus = base64.b64decode(corpus_b64, validate=True)
        except (binascii.Error, TypeError, ValueError) as e:
            raise ValueError(f"bad_spec\ncorpus_b64 does not decode: {e}")
    else:
        try:
            with open(path, "rb") as f:
                if max_corpus_bytes is None:
                    corpus = f.read()
                else:
                    corpus = f.read(max_corpus_bytes + 1)
        except OSError as e:
            raise ValueError(f"bad_spec\ncorpus path unreadable: {e}")
        if max_corpus_bytes is not None and len(corpus) > max_corpus_bytes:
            raise ValueError(
                f"corpus_too_large\ncorpus at {path!r} exceeds the "
                f"daemon cap ({max_corpus_bytes} bytes)"
            )
    overrides = req.get("config") or {}
    if not isinstance(overrides, dict):
        raise ValueError("bad_spec\nconfig must be an object of knobs")
    unknown = set(overrides) - set(SPEC_CONFIG_KEYS)
    if unknown:
        raise ValueError(
            f"bad_spec\nunknown config keys {sorted(unknown)} "
            f"(allowed: {SPEC_CONFIG_KEYS})"
        )
    try:
        cfg = EngineConfig(**overrides)
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad_spec\n{e}")
    try:
        weight = float(req.get("weight", 1.0))
    except (TypeError, ValueError):
        raise ValueError("bad_spec\nweight must be a number")
    if not 0.0 < weight <= 100.0:
        raise ValueError(f"bad_spec\nweight must be in (0, 100], got {weight}")
    deadline_s = req.get("deadline_s")
    if deadline_s is not None:
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError):
            raise ValueError("bad_spec\ndeadline_s must be a number")
        if not 0.0 < deadline_s <= DEADLINE_CAP_S:
            raise ValueError(
                f"bad_spec\ndeadline_s must be in (0, {DEADLINE_CAP_S}], "
                f"got {deadline_s}"
            )
    try:
        max_attempts = int(req.get("max_attempts", 4))
    except (TypeError, ValueError):
        raise ValueError("bad_spec\nmax_attempts must be an integer")
    if not 1 <= max_attempts <= MAX_ATTEMPTS_CAP:
        raise ValueError(
            f"bad_spec\nmax_attempts must be in [1, {MAX_ATTEMPTS_CAP}], "
            f"got {max_attempts}"
        )
    tenant = str(req.get("tenant", "default"))[:64] or "default"
    spec = JobSpec(
        tenant=tenant,
        workload=workload,
        cfg=cfg,
        weight=weight,
        invalidate=bool(req.get("invalidate")),
        no_cache=bool(req.get("no_cache")),
        deadline_s=deadline_s,
        max_attempts=max_attempts,
        plan=plan_json,
    )
    return spec, corpus


def pairs_bytes(pairs) -> int:
    """Approximate retained size of a result pairs list: key bytes plus
    a small per-pair constant for tuple/int overhead.  An estimate is
    enough — the byte caps guard against multi-GB retention, not
    byte-exact accounting."""
    return sum(len(k) + 16 for k, _ in pairs)


@dataclasses.dataclass
class Job:
    """Runtime record for one admitted job.

    NOT thread-safe by itself: the daemon mutates jobs only under its own
    lock (submit/cancel handlers) or from the single dispatcher thread
    (running -> done/failed), with the state transitions serialized
    through ``FairScheduler``'s lock.
    """

    job_id: str
    spec: JobSpec
    corpus_digest: str
    n_lines: int
    n_blocks: int
    bucket: int               # shape-bucketed block count (cache.bucket_blocks)
    state: str = "queued"
    submitted_s: float = dataclasses.field(default_factory=time.monotonic)
    started_s: float | None = None
    finished_s: float | None = None
    cache: str = "cold"       # "result" | "warm" | "cold" — how it was served
    result: list | None = None            # [(key bytes, value int), ...]
    result_bytes: int = 0                 # pairs_bytes(result) at finish
    error: dict | None = None             # structured_error() dict
    distinct: int | None = None
    truncated: bool = False
    overflow_tokens: int = 0
    batch_size: int | None = None         # jobs coalesced into its dispatch
    attempts: int = 0                     # dispatches this job has ridden
    # Bisection tag (docs/SERVING.md): jobs from a failed multi-job batch
    # split into halves that must not re-coalesce — the dispatcher's
    # batch_key includes this, so a poison job is isolated in log2(batch)
    # extra dispatches while its innocent neighbors succeed.
    bisect_group: str | None = None
    # Raw submit ``config`` overrides, kept for the write-ahead journal:
    # replay rebuilds the EngineConfig from exactly what the client sent.
    config_overrides: dict | None = None
    # Scale-out placement (docs/SERVING.md "Scale-out dispatch"): where
    # the LAST dispatch ran — "local", a pool worker's "host:port", or
    # "shard" for a fanned-out large job; None until first dispatch.
    placed_on: str | None = None
    shards: int | None = None  # shard count for a fanned-out large job

    def deadline_mono(self) -> float | None:
        """Absolute monotonic deadline, or None.  Anchored at submit
        time — replay re-anchors (a restart restores the job, not the
        wall-clock budget it already burned; docs/SERVING.md)."""
        if self.spec.deadline_s is None:
            return None
        return self.submitted_s + self.spec.deadline_s

    def expired(self, now: float) -> bool:
        d = self.deadline_mono()
        return d is not None and now >= d

    def queue_ms(self) -> float | None:
        if self.started_s is None:
            return None
        return round((self.started_s - self.submitted_s) * 1e3, 3)

    def latency_ms(self) -> float | None:
        if self.finished_s is None:
            return None
        return round((self.finished_s - self.submitted_s) * 1e3, 3)

    def public(self) -> dict:
        """The ``status`` reply body (no result payload — that is the
        ``result`` command's job, results can be MBs)."""
        return {
            "job_id": self.job_id,
            "state": self.state,
            "tenant": self.spec.tenant,
            "workload": self.spec.workload,
            "corpus_digest": self.corpus_digest,
            "n_lines": self.n_lines,
            "n_blocks": self.n_blocks,
            "bucket": self.bucket,
            "cache": self.cache,
            "queue_ms": self.queue_ms(),
            "latency_ms": self.latency_ms(),
            "batch_size": self.batch_size,
            "placed_on": self.placed_on,
            "shards": self.shards,
            "attempts": self.attempts,
            "max_attempts": self.spec.max_attempts,
            "deadline_s": self.spec.deadline_s,
            "error": self.error,
        }
