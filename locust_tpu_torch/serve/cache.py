"""The serve tier's two cache layers + warm-state persistence.

The port's copy of the JAX package's ``serve/cache.py``: the same keys,
counters, LRU and byte caps, and the same warm-file format, so a warm
directory written by either package restores in the other.

**Warm-executable cache** (``ExecutableCache``): engines keyed by
``(workload, EngineConfig.fingerprint(), shape bucket)``, built on the
daemon's device.  The port has no jit: its "compile" is the first
dispatch of an engine at a batched ``(padded jobs, bucket)`` shape (the
first launches of the kernels at that shape), counted exactly where the
JAX cache counts an XLA compile, so hits, misses, builds and compiles,
and the ``cold``/``warm`` answers, equal the JAX daemon's under the same
submits.  Buckets round a job's block count up a power-of-two ladder
(``bucket_blocks``), so small jobs of different sizes share one shape at
the cost of folding a few zero blocks (zero lines emit nothing).
Engines are LRU-bounded.  An engine keeps no device tensor between
dispatches (each fold's tensors die with the fold), so evicting one
drops the last reference to everything it allocated.

**Result cache** (``ResultCache``): finished tables keyed by
``(corpus digest, spec fingerprint)``; a repeat of the SAME bytes under
the SAME program is answered without touching the engine.  Explicit
invalidation only; the key includes the corpus sha256, so different
BYTES never alias.

**Sub-plan cache** (``SubPlanCache``): per-edge plan fold results keyed
by (closure fingerprint, config fingerprint, corpus sha256), the plan
compiler's cross-tenant cache (plan/compile.py ``_RunCtx``).

**Warm-state persistence** (``WarmState``): the result cache survives
daemon restarts by riding the port's bounded async snapshot writer
(io/snapshot.py: ``AsyncCheckpointWriter``, ``finalize_snapshot`` with
the ``io.ckpt_write``/``io.checkpoint`` fault sites).  A missing,
corrupt or version-skewed warm file costs a cold start, never a crash
and never a wrong answer.

torch-free at import: the engine, the plan compiler and io/snapshot load
lazily, when the daemon builds an engine or a ``WarmState``.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading

from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.serve.jobs import (
    PLAN_WORKLOAD,
    WORKLOADS,
    JobSpec,
    pairs_bytes,
)

logger = logging.getLogger("locust_tpu")

# Warm-file format version: bumped on layout changes so an old daemon's
# file is a clean cold start for a new one, not a parse crash.
WARM_VERSION = 1
WARM_FILE = "serve_warm.json"


def bucket_blocks(n_blocks: int) -> int:
    """Shape-bucket ladder: block counts round UP to the next power of
    two, so jobs of nearby sizes share one compiled executable (the
    padding cost is bounded by <2x blocks, and padded blocks are all-NUL
    rows the map stage emits nothing for)."""
    n = max(1, int(n_blocks))
    b = 1
    while b < n:
        b <<= 1
    return b


def _resolve_workload(name: str):
    """Lazy map-fn import (torch enters the process here, not at module
    import): 'pkg.mod:attr' -> (map_fn, combine)."""
    path, combine = WORKLOADS[name]
    mod_name, _, attr = path.partition(":")
    import importlib

    return getattr(importlib.import_module(mod_name), attr), combine


class ExecutableCache:
    """Warm engines + compiled-shape tracking, hit/miss accounted.

    A LOOKUP is a hit iff the engine for ``(workload, cfg fingerprint)``
    exists AND the exact batched dispatch shape ``(njobs, bucket)`` has
    run before.  Anything else is a miss that pays the build and/or the
    first dispatch at the shape; the stats make the distinction auditable
    (a repeat job reports ``compiles`` unchanged).  Engines and compiled
    plans are built on ``device`` (None = CUDA, as every entry point).
    """

    def __init__(self, max_engines: int = 4, device=None):
        if max_engines < 1:
            raise ValueError("max_engines must be >= 1")
        self.max_engines = max_engines
        self.device = device
        self._lock = threading.Lock()
        self._engines: dict[tuple, object] = {}  # key -> engine (LRU order)
        self._shapes: set[tuple] = set()         # (key, njobs, bucket)
        self.hits = 0
        self.misses = 0
        self.builds = 0     # engines constructed
        self.compiles = 0   # batched shapes first-dispatched
        self.evictions = 0

    @staticmethod
    def engine_key(spec: JobSpec) -> tuple:
        if spec.plan is not None:
            # Plan jobs: the compiled executable is the (plan, config)
            # pair, so the plan fingerprint IS the workload half of the
            # key — two different pipelines can never share a warm
            # engine, and a repeat of the same plan always hits
            # (docs/PLAN.md).
            return (
                PLAN_WORKLOAD, spec.plan_fingerprint(),
                spec.cfg.fingerprint(),
            )
        return (spec.workload, spec.cfg.fingerprint())

    @staticmethod
    def fold_node_key(node_fp: str, cfg_fp: str) -> tuple:
        """The warm key for a distributed plan MAP STAGE's fold engine:
        (plan-node closure fingerprint, config fingerprint).  The
        closure fp (``Plan.node_fingerprint``) is node-id independent,
        so an alpha-renamed resubmit of the same pipeline lands on the
        same warm executable — and the shape bucket rides the ledger
        exactly as for whole jobs, so a repeat distributed plan skips
        the per-worker first dispatch (docs/PLAN.md "Distributed
        execution")."""
        return (PLAN_WORKLOAD, f"node:{node_fp}", cfg_fp)

    def _lookup_key(self, key: tuple, njobs: int, bucket: int, build):
        """(engine, hit) for one warm key — builds via ``build()`` on a
        miss; the SHAPE is marked compiled only by ``_mark_key`` after
        the dispatch ran (a dispatch that dies must not poison the
        ledger as warm)."""
        with self._lock:
            eng = self._engines.pop(key, None)
            if eng is not None:
                self._engines[key] = eng  # LRU touch
                if (key, njobs, bucket) in self._shapes:
                    self.hits += 1
                    return eng, True
                self.misses += 1
                return eng, False
            self.misses += 1
        # Build OUTSIDE the lock: engine construction touches nothing
        # device-side yet, but it is not free and must not block
        # concurrent lookups of already-warm keys.
        built = build()
        with self._lock:
            eng = self._engines.get(key)
            if eng is None:  # we won the (benign) build race
                eng = built
                self._engines[key] = eng
                self.builds += 1
                while len(self._engines) > self.max_engines:
                    evicted_key = next(iter(self._engines))
                    self._engines.pop(evicted_key)
                    self._shapes = {
                        s for s in self._shapes if s[0] != evicted_key
                    }
                    self.evictions += 1
            return eng, False

    def _mark_key(self, key: tuple, njobs: int, bucket: int) -> None:
        with self._lock:
            shape = (key, njobs, bucket)
            if shape not in self._shapes:
                self._shapes.add(shape)
                self.compiles += 1

    def lookup(self, spec: JobSpec, njobs: int, bucket: int):
        """(engine, hit) — builds the engine on a miss (see
        ``_lookup_key`` for the ledger discipline)."""

        def build():
            if spec.plan is not None:
                # Plan jobs hold a CompiledPlan instead of a bare
                # engine: same LRU, same shape ledger, same warm-hit
                # accounting (the compiled plan keeps its engine).
                from locust_tpu_torch.plan import from_json
                from locust_tpu_torch.plan.compile import compile_plan

                return compile_plan(from_json(spec.plan), spec.cfg,
                                    device=self.device)
            from locust_tpu_torch.engine import MapReduceEngine

            map_fn, combine = _resolve_workload(spec.workload)
            return MapReduceEngine(
                spec.cfg, map_fn=map_fn, combine=combine,
                device=self.device,
            )

        return self._lookup_key(self.engine_key(spec), njobs, bucket,
                                build)

    def lookup_fold_node(self, node_fp: str, cfg, njobs: int,
                         bucket: int):
        """(engine, hit) for a distributed plan map stage, keyed by the
        fold node's CLOSURE fingerprint (``fold_node_key``).  Only the
        wordcount fold dispatches device-side on workers (the composite
        folds shuffle host-built pair tables), so the engine is always
        the wordcount map/combine under the stage's config."""

        def build():
            from locust_tpu_torch.engine import MapReduceEngine

            map_fn, combine = _resolve_workload("wordcount")
            return MapReduceEngine(cfg, map_fn=map_fn, combine=combine,
                                   device=self.device)

        return self._lookup_key(
            self.fold_node_key(node_fp, cfg.fingerprint()), njobs,
            bucket, build,
        )

    def mark_compiled(self, spec: JobSpec, njobs: int, bucket: int) -> None:
        self._mark_key(self.engine_key(spec), njobs, bucket)

    def mark_compiled_fold_node(self, node_fp: str, cfg_fp: str,
                                njobs: int, bucket: int) -> None:
        self._mark_key(self.fold_node_key(node_fp, cfg_fp), njobs,
                       bucket)

    def warm_shapes(self) -> list[list]:
        """Every compiled shape as ``[workload, cfg_fp, njobs, bucket]``
        rows — what a serve worker's ``serve_stats`` reply carries (the
        JAX pool seeds its affinity map from it)."""
        with self._lock:
            return [
                [key[0], key[1], njobs, bucket]
                for (key, njobs, bucket) in sorted(self._shapes)
            ]

    def stats(self) -> dict:
        with self._lock:
            # Megakernel visibility: how many warm engines actually run
            # the fused kernel vs were demoted at construction (stats is
            # where an operator finds out a fused-mode daemon is
            # silently folding like hasht — the engines log the reason
            # once, this keeps it visible after the log rotates).  Plan
            # executables hold their engine as ``_engine`` (None until
            # the first fold builds it).
            fused_on = fused_demoted = 0
            for eng in self._engines.values():
                e = getattr(eng, "_engine", eng)
                if getattr(e, "_fused_kernel_on", False):
                    fused_on += 1
                if getattr(e, "_fused_demoted", False):
                    fused_demoted += 1
            return {
                "engines": len(self._engines),
                "shapes": len(self._shapes),
                "hits": self.hits,
                "misses": self.misses,
                "builds": self.builds,
                "compiles": self.compiles,
                "evictions": self.evictions,
                "fused_on": fused_on,
                "fused_demoted": fused_demoted,
            }


class ResultCache:
    """Finished tables keyed by (corpus sha256, spec fingerprint)."""

    def __init__(self, max_entries: int = 256,
                 max_bytes: int = 256 << 20):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        # Entry COUNT alone cannot bound memory: 256 entries of
        # multi-MB pair lists is GBs of retention, the same
        # overload-must-reject-not-OOM class as the daemon's queue
        # byte cap.  LRU eviction runs on whichever cap trips first.
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str], dict] = {}  # LRU order
        self._bytes = 0  # sum of entry "bytes" estimates
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def get(self, digest: str, spec_fp: str) -> list | None:
        hit = self.get_with_meta(digest, spec_fp)
        return None if hit is None else hit[0]

    def get_with_meta(
        self, digest: str, spec_fp: str
    ) -> tuple[list, dict] | None:
        """(pairs, meta) on a hit — meta carries the ORIGINAL run's
        distinct/truncated/overflow_tokens so a replayed lossy result
        stays flagged lossy (daemon submit path)."""
        with self._lock:
            ent = self._entries.pop((digest, spec_fp), None)
            if ent is None:
                self.misses += 1
                return None
            self._entries[(digest, spec_fp)] = ent  # LRU touch
            ent["hits"] += 1
            self.hits += 1
            return ent["pairs"], dict(ent["meta"])

    def put(self, digest: str, spec_fp: str, pairs: list,
            meta: dict | None = None) -> None:
        size = pairs_bytes(pairs)
        with self._lock:
            old = self._entries.pop((digest, spec_fp), None)
            if old is not None:
                self._bytes -= old["bytes"]
            self._entries[(digest, spec_fp)] = {
                "pairs": list(pairs),
                "bytes": size,
                "hits": 0,
                "meta": dict(meta or {}),
            }
            self._bytes += size
            while (len(self._entries) > self.max_entries
                   or self._bytes > self.max_bytes):
                if len(self._entries) == 1:
                    break  # a single oversized entry still serves hits
                ent = self._entries.pop(next(iter(self._entries)))
                self._bytes -= ent["bytes"]

    def invalidate(self, digest: str | None = None,
                   spec_fp: str | None = None) -> int:
        """Drop matching entries (both None = everything); returns count."""
        with self._lock:
            doomed = [
                k for k in self._entries
                if (digest is None or k[0] == digest)
                and (spec_fp is None or k[1] == spec_fp)
            ]
            for k in doomed:
                self._bytes -= self._entries.pop(k)["bytes"]
            self.invalidations += len(doomed)
            return len(doomed)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
            }

    # ------------------------------------------------- (de)serialization

    def dump(self) -> list[dict]:
        # Shallow snapshot under the lock, base64 OUTSIDE it: the encode
        # is O(total cached pairs) and must not stall concurrent lookups
        # (pairs lists are never mutated after put(), so reading them
        # lock-free is safe).
        with self._lock:
            snapshot = [
                (k, ent["pairs"], dict(ent["meta"]))
                for k, ent in self._entries.items()
            ]
        return [
            {
                "digest": k[0],
                "spec_fp": k[1],
                "pairs": [
                    [base64.b64encode(key).decode(), int(v)]
                    for key, v in pairs
                ],
                "meta": meta,
            }
            for k, pairs, meta in snapshot
        ]

    def load(self, rows: list[dict]) -> int:
        n = 0
        for row in rows:
            try:
                pairs = [
                    (base64.b64decode(k), int(v)) for k, v in row["pairs"]
                ]
                self.put(str(row["digest"]), str(row["spec_fp"]), pairs,
                         meta=row.get("meta"))
                n += 1
            except (KeyError, TypeError, ValueError) as e:
                # One rotten entry must not cost the warm start.
                logger.warning("serve warm entry skipped (%s)", e)
        return n


class SubPlanCache:
    """Per-EDGE fold results keyed by (closure fingerprint, config
    fingerprint, corpus sha256) — the plan optimizer's cross-tenant
    sub-plan cache (docs/PLAN.md "Optimizer").

    Generalizes ``ResultCache``'s byte-identity discipline from whole-
    job to per-edge: the closure fingerprint
    (``Plan.node_fingerprint``) is node-id independent, so two tenants
    whose plans spell the same corpus + tokenize prefix under different
    names share the entry.  Same bounding stance as ``ResultCache``
    (byte-capped LRU, count cap, one oversized entry still serves),
    same explicit invalidation.  IN-MEMORY ONLY by design: WAL replay
    after a restart recomputes from a cold cache and must reproduce the
    same bytes — the optimizer's identity contract, pinned by tests.

    Entries are dicts built by ``plan/compile._RunCtx`` (value + loss
    accounting + ``corpus_len``/``corpus_sha``/``n_lines`` + a
    ``bytes`` size estimate).  ``prefix_candidates`` feeds the
    incremental-refold probe: entries under the same (closure, config)
    identity, newest-corpus first, whose corpus may be a verified
    prefix of a grown resubmit (``optimize.incremental_delta`` does the
    hash verification — nothing here trusts a client).
    """

    def __init__(self, max_entries: int = 256,
                 max_bytes: int = 128 << 20):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        # key: (closure_fp, cfg_fp, corpus_sha) -> entry dict (LRU order)
        self._entries: dict[tuple[str, str, str], dict] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.incremental_hits = 0
        self.invalidations = 0
        # Last incremental merge's block accounting (bench/check
        # evidence: the delta refold must touch FEWER blocks than a
        # full one).
        self.last_delta_blocks = 0
        self.last_total_blocks = 0

    def get(self, closure_fp: str, cfg_fp: str,
            corpus_sha: str) -> dict | None:
        with self._lock:
            ent = self._entries.pop((closure_fp, cfg_fp, corpus_sha),
                                    None)
            if ent is None:
                self.misses += 1
                return None
            self._entries[(closure_fp, cfg_fp, corpus_sha)] = ent
            self.hits += 1
            return ent

    def put(self, closure_fp: str, cfg_fp: str, corpus_sha: str,
            entry: dict) -> None:
        size = int(entry.get("bytes") or 0)
        key = (closure_fp, cfg_fp, corpus_sha)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= int(old.get("bytes") or 0)
            self._entries[key] = entry
            self._bytes += size
            while (len(self._entries) > self.max_entries
                   or self._bytes > self.max_bytes):
                if len(self._entries) == 1:
                    break  # one oversized entry still serves hits
                ent = self._entries.pop(next(iter(self._entries)))
                self._bytes -= int(ent.get("bytes") or 0)

    def prefix_candidates(self, closure_fp: str,
                          cfg_fp: str) -> list[dict]:
        """Entries under (closure_fp, cfg_fp) regardless of corpus —
        largest corpus first, so the incremental probe tries the
        longest verified prefix (smallest delta) before older
        generations."""
        with self._lock:
            ents = [
                ent for (fp, cf, _sha), ent in self._entries.items()
                if fp == closure_fp and cf == cfg_fp
            ]
        return sorted(
            ents, key=lambda e: int(e.get("corpus_len") or 0),
            reverse=True,
        )

    def record_incremental(self, delta_blocks: int,
                           total_blocks: int) -> None:
        with self._lock:
            self.incremental_hits += 1
            self.last_delta_blocks = int(delta_blocks)
            self.last_total_blocks = int(total_blocks)

    def invalidate(self, corpus_sha: str | None = None) -> int:
        """Drop entries for one corpus (None = everything); returns the
        count.  Rides the daemon's existing invalidation surface: an
        ``--invalidate`` submit or an explicit invalidate for a corpus
        digest drops the per-edge entries too — a tenant asking for a
        fresh recompute must not be answered from a sub-plan edge."""
        with self._lock:
            doomed = [
                k for k in self._entries
                if corpus_sha is None or k[2] == corpus_sha
            ]
            for k in doomed:
                self._bytes -= int(self._entries.pop(k).get("bytes") or 0)
            self.invalidations += len(doomed)
            return len(doomed)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "incremental_hits": self.incremental_hits,
                "invalidations": self.invalidations,
                "last_delta_blocks": self.last_delta_blocks,
                "last_total_blocks": self.last_total_blocks,
            }


class WarmState:
    """Persist the result cache across daemon restarts, asynchronously.

    ``mark(generation)`` hands a serialize-closure to the bounded
    latest-wins ``AsyncCheckpointWriter`` (io/snapshot.py) — the dispatch
    loop never blocks on disk; ``finalize_snapshot`` publishes atomically
    through the existing ``io.ckpt_write``/``io.checkpoint`` chaos sites.
    ``load()`` at daemon startup restores entries; any failure is a cold
    start, logged, never fatal.
    """

    def __init__(self, warm_dir: str, results: ResultCache):
        # Lazy: the port's io package imports torch, and this module
        # must stay importable without it — the thin client (submit/
        # stats/shutdown against a remote daemon) must not pay torch's
        # import.  Only the daemon constructs a WarmState.
        from locust_tpu_torch.io.snapshot import (
            AsyncCheckpointWriter,
            finalize_snapshot,
        )

        self._finalize_snapshot = finalize_snapshot
        self.path = os.path.join(warm_dir, WARM_FILE)
        self._results = results
        os.makedirs(warm_dir, exist_ok=True)
        self._writer = AsyncCheckpointWriter(name="serve-warm-writer")

    def load(self) -> int:
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
        except OSError:
            return 0  # no warm file: cold start
        except ValueError as e:
            logger.warning(
                "serve warm state %s unreadable (%s); cold start",
                self.path, e,
            )
            return 0
        if not isinstance(doc, dict) or doc.get("version") != WARM_VERSION:
            logger.warning(
                "serve warm state %s has version %r (want %d); cold start",
                self.path, getattr(doc, "get", lambda _: None)("version"),
                WARM_VERSION,
            )
            return 0
        n = self._results.load(doc.get("results") or [])
        logger.info("serve warm state: restored %d cached result(s)", n)
        return n

    def mark(self, generation: int) -> None:
        # The whole serialize — dump() included — runs in the write
        # closure ON THE WRITER THREAD: encoding every cached pair is
        # O(total cached bytes) and would otherwise bill the dispatch
        # loop this layer promises never to block.  The file then
        # carries the cache state at WRITE time (fresher than mark time,
        # which is fine: it is a cache, and latest-wins already skips
        # lapped generations).
        def write():
            doc = {"version": WARM_VERSION, "generation": generation,
                   "results": self._results.dump()}
            tmp = f"{self.path}.tmp.{generation}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            self._finalize_snapshot(tmp, self.path, generation=generation)

        self._writer.submit(generation, write)

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()

    def stats(self) -> dict:
        return dict(self._writer.stats(), path=self.path)
