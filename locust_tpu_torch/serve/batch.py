"""Shape-bucketed batching: many compatible jobs, ONE engine dispatch.

The port's copy of the JAX package's ``serve/batch.py``.  The dispatcher
hands this module a batch of jobs that FairScheduler already proved
compatible — same executable key (workload + EngineConfig fingerprint)
and same shape bucket — and it:

  1. stages every job's corpus into one ``[njobs, bucket, block_lines,
     line_width]`` uint8 stack on the host (job axis padded up the same
     power-of-two ladder as the block axis, the JAX shapes), page-locked
     for a CUDA engine, and copies it to the engine's device once;
  2. runs ``MapReduceEngine.run_batch``: every job folds into its own
     table, one host sync for the lot;
  3. the caller demultiplexes per-job tables back into host (key, count)
     pairs, dropping the padded job slots.

Padding is correct by the engine's semantics: all-NUL rows tokenize to
nothing, and a zero-filled job slot folds to an empty table that is
simply discarded.  The padded blocks and job slots are folded all the
same, as in JAX, so every kernel launch count of a batch counts them.

torch-free at import; ``stage_batch`` and ``merge_shard_results`` import
it when they run.
"""

from __future__ import annotations

import numpy as np

from locust_tpu_torch.serve.cache import bucket_blocks
from locust_tpu_torch.serve.jobs import Job


def split_lines(corpus: bytes) -> list[bytes]:
    """Corpus bytes -> lines, the same way the CLI ingests files."""
    return corpus.splitlines()


def count_lines(corpus: bytes) -> int:
    """``len(corpus.splitlines())`` WITHOUT materializing the list —
    admission only needs the count.  bytes.splitlines breaks on \\n, \\r
    and \\r\\n (one break each), plus a trailing partial line."""
    if not corpus:
        return 0
    n = (
        corpus.count(b"\n") + corpus.count(b"\r") - corpus.count(b"\r\n")
    )
    if not corpus.endswith((b"\n", b"\r")):
        n += 1
    return n


def job_shape(n_lines: int, cfg) -> tuple[int, int]:
    """(n_blocks, bucket) for a corpus under ``cfg`` — the shape half of
    the warm-cache key, computed once at admission."""
    n_blocks = max(1, -(-n_lines // cfg.block_lines))
    return n_blocks, bucket_blocks(n_blocks)


def stage_batch(engine, jobs: list[Job], corpora: dict):
    """Build the ``[padded_jobs, bucket, block_lines, width]`` stack on
    the host and copy it to ``engine.device`` once (page-locked first on
    CUDA, so the copy is one DMA).  ``corpora`` maps corpus digest ->
    raw bytes or a pre-split line list.  The job axis pads to
    ``bucket_blocks(len(jobs))``, as in JAX."""
    import torch

    cfg = engine.cfg
    bucket = jobs[0].bucket
    bl, w = cfg.block_lines, cfg.line_width
    njobs = bucket_blocks(len(jobs))
    stack = np.zeros((njobs, bucket, bl, w), dtype=np.uint8)
    for j, job in enumerate(jobs):
        data = corpora[job.corpus_digest]
        lines = data if isinstance(data, list) else split_lines(data)
        rows = engine.rows_from_lines(lines)
        n = rows.shape[0]
        flat = stack[j].reshape(bucket * bl, w)
        if n > flat.shape[0]:
            raise ValueError(
                f"job {job.job_id}: {n} staged lines exceed the batch "
                f"shape ({bucket} blocks x {bl} lines)"
            )
        flat[:n] = rows[:, :w]
    host = torch.from_numpy(stack)
    if engine.device.type == "cuda":
        return host.pin_memory().to(engine.device, non_blocking=True)
    return host


def dispatch_batch(engine, jobs: list[Job], corpora: dict):
    """Stage + run one coalesced dispatch; returns the per-job RunResults
    (padded job slots dropped).  Pure compute — spans and accounting are
    the daemon's."""
    blocks = stage_batch(engine, jobs, corpora)
    results = engine.run_batch(blocks)
    return results[: len(jobs)]


def merge_shard_results(
    shard_results: list[dict], cfg, combine: str = "sum", device=None
) -> tuple[list[tuple[bytes, int]], int, bool, int]:
    """Merge per-shard tables through the engine's own combine.

    ``shard_results`` are per-shard replies (``pairs`` as (key bytes,
    value) tuples plus the truncated/overflow flags).  The shard tables
    are concatenated as one emit batch, ``sort_and_compact`` +
    ``segment_reduce``'d on ``device`` (None = CUDA) and decoded exactly,
    as the JAX merge does, so a sharded job's table equals the unsharded
    fold's whenever the merged distinct count fits the configured table.

    Returns ``(pairs, distinct, truncated, overflow_tokens)``.
    """
    import torch

    from locust_tpu_torch.core.kv import KVBatch
    from locust_tpu_torch.engine import finalize_host_pairs, resolve_device
    from locust_tpu_torch.ops.process_stage import sort_and_compact
    from locust_tpu_torch.ops.reduce_stage import segment_reduce

    dev = resolve_device(device)
    kw = cfg.key_width
    all_pairs = [p for res in shard_results for p in res["pairs"]]
    overflow = sum(int(res.get("overflow_tokens", 0)) for res in shard_results)
    shard_truncated = any(bool(res.get("truncated")) for res in shard_results)
    if not all_pairs:
        return [], 0, shard_truncated, overflow
    keys = np.zeros((len(all_pairs), kw), dtype=np.uint8)
    values = np.zeros(len(all_pairs), dtype=np.int32)
    for i, (k, v) in enumerate(all_pairs):
        kb = k[:kw]
        keys[i, : len(kb)] = np.frombuffer(kb, dtype=np.uint8)
        values[i] = v
    batch = KVBatch.from_bytes(
        torch.from_numpy(keys).to(dev), torch.from_numpy(values).to(dev),
        torch.ones(len(all_pairs), dtype=torch.bool, device=dev),
    )
    table = segment_reduce(sort_and_compact(batch, cfg.sort_mode), combine)
    pairs = finalize_host_pairs(table, combine)
    distinct = len(pairs)
    truncated = shard_truncated or distinct > cfg.resolved_table_size
    return pairs, distinct, truncated, overflow
