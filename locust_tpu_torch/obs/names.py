"""The closed telemetry name registry — every span, instant event and
metric the framework can emit, in ONE dict literal.

Port of ``locust_tpu/obs/names.py``, copied whole: the two packages
share one vocabulary, so a timeline of either reads the same.  Every
JAX name keeps its kind here.  The port adds one section of its own, at
the end of the dict: spans inside the fold, the reader thread, PageRank's
job and the sample sort's phases, and the host-sync, iteration, sort,
partition-kernel and all-to-all counters, which the JAX package (one
traced ``lax.scan`` per fold) has no place for.

Closed-registry stance (same as ``faultplan.SITES`` and the analysis rule
table): a typo'd name at an emission site must fail LOUDLY — at runtime
(``Tracer``/``Metrics`` validate against this dict when telemetry is
enabled).  A name nobody validates is a timeline nobody can correlate.

Emission convention: emit through the ``obs`` module
functions with a literal name — ``obs.span("engine.stage.map")``, never a
name built at runtime.  Kinds: ``span`` (duration), ``event`` (instant),
``counter``/``gauge``/``histogram`` (metrics).
"""

from __future__ import annotations

NAMES = {
    # --- spans (durations) -------------------------------------------
    "job.run": "span",              # master: one distributor job end-to-end
    "master.map_rpc": "span",       # master: one shard map attempt RPC
    "master.fetch": "span",         # master: one intermediate transfer
    "worker.map": "span",           # worker: one map command (runner incl.)
    "cli.load": "span",             # CLI: corpus ingest
    "cli.run": "span",              # CLI: the engine run
    "cli.output": "span",           # CLI: table print / intermediate write
    "engine.stage.map": "span",     # timed_run Map stage (per block)
    "engine.stage.process": "span", # timed_run Process stage (per block)
    "engine.stage.reduce": "span",  # timed_run Reduce stage (per block)
    "engine.stage.merge": "span",   # timed_run cross-block table merge
    "stream.block": "span",         # run_stream: stage+dispatch of one block
    "ckpt.write": "span",           # async writer: serialize+publish one gen
    "serve.queue_wait": "span",     # serve: dispatcher waiting on the queue
    "serve.compile_or_hit": "span", # serve: warm-executable cache lookup/build
    "serve.dispatch": "span",       # serve: one coalesced batch dispatch
    "serve.place": "span",          # serve: pool placement decision (pool.py)
    "serve.demux": "span",          # serve: per-job result split + store
    "serve.ship": "span",           # serve: one WAL ship/catch-up RPC (replicate.py)
    "plan.optimize": "span",        # plan: the rewrite pass (optimize.py)
    "plan.compile": "span",         # plan: DAG lowering onto the engine
    "plan.run": "span",             # plan: one compiled-plan execution
    "plan.stage": "span",           # plan: one distributed stage RPC (both sides)
    "plan.shuffle": "span",         # plan: one cross-worker partition transfer
    # --- instant events ----------------------------------------------
    "fault.injected": "event",      # a faultplan rule fired (site, action)
    "ckpt.mark": "event",           # fold loop marked a snapshot generation
    "ckpt.publish": "event",        # finalize_snapshot atomic rename landed
    "ckpt.skip": "event",           # latest-wins replaced a pending mark
    "stream.stall": "event",        # bounded-inflight backpressure sync
    "obs.device_join": "event",     # xplane family times joined onto a stage
    "serve.admit": "event",         # serve: job admitted to the queue
    "serve.reject": "event",        # serve: admission rejected (reason code)
    "serve.retry": "event",         # serve: failed dispatch requeued w/ backoff
    "serve.replay": "event",        # serve: journal replay summary at startup
    "serve.takeover": "event",      # serve: role change (promotion / demotion)
    "backend.breaker_open": "event",       # breaker tripped: primary ineligible
    "backend.breaker_half_open": "event",  # cooldown over: one probe allowed
    "backend.breaker_close": "event",      # probe succeeded: primary restored
    "backend.failover": "event",    # locust: noqa[R009] kept so every JAX name is registered (traces interoperate); the port's breaker retries on the card after its cooldown and never fails over to the CPU
    # --- metrics ------------------------------------------------------
    "job.workers": "gauge",         # cluster size of the running job
    "stream.blocks": "counter",     # blocks folded by run_stream
    "stream.stall_ms": "histogram", # per-sync backpressure stall
    "ckpt.marks": "counter",        # snapshot generations marked
    "fault.injections": "counter",  # faults injected across all sites
    "fetch.bytes": "counter",       # intermediate payload bytes fetched
    "fetch.mb_s": "histogram",      # per-fetch payload throughput
    "serve.jobs": "counter",        # serve: jobs completed by the daemon
    "serve.latency_ms": "histogram",  # serve: per-job submit->done latency
    "serve.exec_cache_hits": "counter",    # warm-executable cache hits
    "serve.exec_cache_misses": "counter",  # ... and compiles/builds paid
    "serve.result_cache_hits": "counter",  # result cache answered a submit
    "serve.affinity_hits": "counter",      # pool placements on the warm worker
    "serve.journal_ms": "histogram",  # per-append journal write latency
    "serve.ship_lag": "gauge",      # replication lag in unacked WAL records
    "backend.breaker_trips": "counter",  # closed->open breaker transitions
    "plan.partition_bytes": "counter",  # published shuffle-partition bytes
    "plan.recomputes": "counter",   # plan stages recomputed after a failure
    "plan.speculated": "counter",   # speculative backup stage attempts
    "plan.rewrites": "counter",     # optimizer rewrites applied (optimize.py)
    "plan.subcache_hits": "counter",    # sub-plan result cache hits
    "plan.subcache_misses": "counter",  # ... and fold recomputes paid
    "plan.solo_fallbacks": "counter",   # plan jobs demoted to the solo engine
    "plan.map_warm_hits": "counter",    # map stages on warm fold-node executables
    # --- port only: inside the fold and the reader thread -------------
    "engine.stage_blocks": "span",  # pad host rows for the card: prepare_blocks (+ the copy), run_stream's ring
    "engine.fold.block": "span",    # _fold_all: one block's fold step (eager, or one graph replay)
    "engine.fold.map": "span",      # fold_block: map_fn, or kernel C + its flag read; under the fold graph only in its capture
    "engine.fold.sort": "span",     # fold_into: concat(table, block) + sort_and_compact
    "engine.fold.reduce": "span",   # fold_into: segment_reduce_into, or aggregate_exact
    "engine.fold.drain": "span",    # a fold runner's final wait for the card
    "stream.read": "span",          # prefetch_blocks' reader: one next() of the source
    "stream.wait": "span",          # prefetch_blocks' consumer: blocked on an empty queue
    "engine.host_syncs": "counter", # host reads of fold tensors + explicit waits
    "engine.fold.capture": "span",  # fold_graph: one block's fold warmed up and captured
    "engine.fold.graph_captures": "counter",  # fold graphs captured
    "engine.fold.graph_replays": "counter",   # blocks folded by a fold graph's replay
    "pagerank.prep": "span",        # apps.pagerank: the out-degrees and dangling mask
    "pagerank.grouping": "span",    # apps.pagerank: the in-edge grouping, to its warp-row count read
    "pagerank.iteration": "span",   # apps.pagerank: one pagerank_step on the host
    "pagerank.iterations": "counter",  # pagerank_step calls of pagerank()
    "sample_sort.sample": "span",   # apps.sample_sort: _splitters, to its own count reads
    "sample_sort.partition": "span",  # apps.sample_sort: buckets, partition_packed; decode of arrivals
    "sample_sort.exchange": "span",   # apps.sample_sort: the counts' all-to-all and read, the keys' and records' all_to_all_v
    "sample_sort.local": "span",    # apps.sample_sort: the lex sort_and_compact of what arrived
    "sample_sort.records": "span",  # apps.sample_sort: sort_records' gather into key order
    "sample_sort.rows": "counter",  # valid rows a rank sorted
    "sample_sort.retries": "counter",     # sort_strings' doublings of the skew factor
    "sample_sort.host_syncs": "counter",  # host reads of the sample sort's tensors
    "sample_sort.slots_skipped": "counter",  # bin slots not sent: n_bins x bin_capacity - filled
    "shuffle.partition_launches": "counter",  # stable_partition calls that launched csrc/partition.cu
    "mesh.all_to_all_calls": "counter",  # Mesh.all_to_all(_v) calls that reached the backend
    "mesh.all_to_all_bytes": "counter",  # ... and the bytes they handed over
}

METRIC_KINDS = ("counter", "gauge", "histogram")


def check(name: str, kind: str) -> None:
    """Loud closed-registry validation (enabled-path only)."""
    got = NAMES.get(name)
    if got is None:
        raise ValueError(
            f"telemetry name {name!r} is not in the obs NAMES registry "
            "(locust_tpu_torch/obs/names.py) — register it; a typo'd name "
            "records nothing the timeline can correlate"
        )
    if got != kind:
        raise ValueError(
            f"telemetry name {name!r} is registered as a {got}, "
            f"emitted as a {kind} — kind mismatch"
        )
