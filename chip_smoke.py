#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``locust_tpu_torch/csrc`` with nvcc
(one nvcc per source, all at once),
holds each kernel against its plain PyTorch version on the card at the
shapes of the main path and others (the tokenizer exactly at widths 1 to
2,048, aligned or not, E 1 to 256 and K 4 to 64, and on rows with no
delimiter, only delimiters, tokens across 16-byte boundaries and bytes >=
0x80; the bitonic sort bit for bit against Batcher's network run as torch
ops, keys and payload rows in order; the fused pre-aggregation's
re-merged union, overflow and flag, from one tile to 2,048 tiles in one
call, and every row it writes), then drives the main path -- single-device
WordCount (Map -> Process -> Reduce) at the CLI's default widths, each
run over >= 32 MiB made by replicating ``data/sample_corpus.txt`` (the
CLI reads it from a file in a temporary directory) -- and checks each
output against a plain Python oracle.  The paths: ``sort_mode="bitonic"``
through ``MapReduceEngine.run_fused``, ``MapReduceEngine.timed_run`` and
the CLI; ``sort_mode="fused"`` (the fused kernel + the hash-table fold)
through ``run_fused`` and the CLI (``--sort-mode fused --no-timing``);
``"hasht"`` and ``"hasht-mxu"`` through ``run_fused``; and ``"fused"``
through ``run_fused`` over a seeded corpus whose vocabulary overfills
the kernel's table, so that flagged blocks take the stock re-fold.  Then
the rest of the single-device job: the torch.sort modes (``lex``,
``hash``, ``hashp``, ``hashp2``, ``hash1``, ``radix``) through
``run_fused``; ``run_stream`` over a ``StreamingCorpus`` of the corpus
file under ``fused`` (one kernel launch per segment of blocks) and
``bitonic``, and under ``fused`` over the large vocabulary (one flagged
segment, re-folded whole); ``run_stream`` and ``run_checkpointed``
stopped by an exception after block 50 and resumed from their
snapshots; ``run_batch`` of three jobs; and the staged CLI (stage 1 on
two line ranges, tsv and bin, then stage 2 on both), ``--stream
--checkpoint-dir`` under fused and ``--auto-caps``.  Then the plan layer
and the ladder of apps, every CLI run through the compiled plan: the
WordCount CLI under ``--sort-mode hasht`` (the optimizer's
``fuse_fold_kernel`` rewrite: kernel C once per block); ``index`` and
``tfidf`` over the corpus file with one document per block, byte for
byte against a Python oracle, with their MB/s and a profiler breakdown;
``pagerank`` over a seeded edge list at web-Google's scale (875,713
nodes, 5,105,039 edges) on the card and on the CPU, against a float64
oracle, with iterations per second; and ``--trace-out`` on WordCount
(staged report and ``--stream``) and ``tfidf``, each trace validated
against the port's schema.  Then the measurement and safety modules:
the native reader (``csrc/ingest.cpp``, built with g++ beside the CUDA
kernels) held byte for byte against the Python reader (``load_rows``,
``StreamingCorpus`` blocks, ``measure_caps_stream``, ``read_tsv`` of a
stage-1 intermediate), with ``run_stream`` and the reader alone timed
through both; ``attributed_run`` over ``timed_run`` under bitonic, hasht
and fused and over ``run_fused`` under fused (device families joined
onto the Process spans; kernel B's and C's entry symbols in their
families) and the CLI's ``--profile-dir``; ``LOCUST_DEBUG_CHECKS=1``
``run_fused`` under bitonic and hasht; ``run_checkpointed`` crashed by an
``io.ckpt_write`` fault plan and resumed, a crash of the background
writer under ``run_stream``, and an ``io.checkpoint`` truncation
followed by a clean restart; ``run_stream`` under fused and bitonic over
a 256 MiB seeded Zipf corpus (``io/corpus.write_corpus``, cut from the
1 GiB north star to keep the script inside its time) against a Counter
of its words; and ``utils/roofline.summarize`` beside each MB/s, every
utilisation from the least bytes moved and at most 100%.  Then the
distributed tier: 2 port workers started as processes (``python -m
locust_tpu_torch.distributor.worker``) share the card, and the port's
master, a process too, runs WordCount over them under ``bitonic`` (bin
and tsv intermediates) and ``--sort-mode fused``, each stdout byte for
byte the one-shot CLI's and the oracle's, with the job's, each shard's
and the reduce's times and the data plane's bytes and MB/s from the
master's merged ``--trace-out`` trace (whose ``worker.map`` spans must
come from both workers); a chaos job (a ``worker.map`` crash on one
worker, an ``io.chunk`` corruption on the other) that must stay exact;
``run_checkpointed`` with a ``CircuitBreaker`` under a
``backend.dispatch`` error plan (exact through the trip, the reload and
the half-open probe) and without one, every fold on the card in both;
and the loopback data-plane microbench.  Then the serve daemon
(``locust_tpu_torch.serve``) at the CLI's widths: in this process, a
stream of one-block jobs over 3 tenants coalesced into batches under
``bitonic`` (kernel B) and ``fused`` (kernel C), two jobs at the 16 MiB
inline cap, result-cache repeats, warm and solo jobs, a ``hash`` job and
a ``tfidf`` plan job, every answer the one-shot CLI's and the oracle's,
with exact launch counts (padded job slots and blocks included) and
cache counters; then ``python -m locust_tpu_torch.serve`` as a process
with a journal and a warm dir, killed -9 during a 16 MiB job's dispatch,
restarted (the replay timed alone too), the job's ``result --wait``
byte for byte the one-shot CLI's, a clean restart answering it from the
result cache, and structured ``poison_job`` and ``deadline_exceeded``
answers under a ``serve.dispatch`` error plan.  Then the serve tier's
scale-out and high availability: ``python -m locust_tpu_torch.serve
--workers A,B --shard-min-blocks 16`` over 2 ``python -m
locust_tpu_torch.distributor.worker --serve`` processes sharing the
card: one-block ``bitonic`` and ``fused`` jobs through ``serve_batch``
(repeats warm by affinity), a 16 MiB job sharded over both workers,
distributed ``tfidf``, ``index``, join-tree and PageRank plans (the
first three byte for byte the one-shot CLI's or the solo engine's,
PageRank within a stated tolerance), a worker killed -9 inside a
``serve_batch`` and its job retried on the survivor; then a primary
with ``--journal-dir --ship-to`` killed -9 while a 16 MiB job runs, the
``--standby-of --lease`` standby promoted by its lease and answering
the job under its original id, and a ship of the old epoch refused with
``stale_epoch``.  Then the mesh tier (``locust_tpu_torch.parallel``):
``python -m locust_tpu_torch FILE --mesh`` as a world of one rank in this
process (NCCL) under ``bitonic`` and ``fused`` (kernel C per shard,
``fused_kernel == "mesh"``), worlds of 2 processes sharing the card
(gloo, ``--coordinator/--num-processes/--process-id``) under both, a
checkpointed world crashed by an ``io.ckpt_write`` fault at a snapshot
and resumed, and ``--slices 2`` over 2 and 4 processes; every stdout the
single-device CLI's, with the all-to-all's bytes and time per round and
each process's peak memory.  Then the mesh apps: ``pagerank --mesh``
(``ShardedPageRank``) over the web-sized graph in a world of 1 in this
process and worlds of 2 and 4 processes sharing the card, each stdout
the same world's ``--backend cpu`` stdout, two gather-add launches per
rank and iteration, with the largest distance to a float64 oracle and
the lines differing from the single-device CLI reported; the gather-add
at a world of 2's send-slot and receive shapes (sources and rows two
index spaces) bit for bit against the CSR walk at int32 and int64, with
its times and bounds; ``index --mesh`` in worlds of 1 and 2 against the
oracle (kernel A once per rank and round); ``compile_plan(wordcount_plan(),
cfg, mesh=True)`` in this process under ``bitonic`` and ``hasht``; and
``DistributedSort.sort_rows`` over >= 1 Mi of the corpus's tokens and
``sort_strings`` over a duplicate-heavy list retried once, in worlds of
1 and 2, against numpy's lexsort.  Every shuffle of the mesh tier and the
mesh apps (a WordCount or index round, each drain round, each
``sort_rows``) launches the partition kernel (``csrc/partition.cu``) once
per rank, and each process holds it against its plain version, slot for
slot, at the first call of each shape.  PageRank adds in the CPU's order on the
card (the gather-add kernel, ``csrc/pagerank.cu``): the card's
``pagerank`` CLI must print the CPU CLI's bytes, the pool's PageRank the
solo engine's, and the kernel must equal its plain version (the CSR walk
as torch ops) bit for bit at the web-sized graph with int32 and with
int64 indices and on a pool rank shard's dst-restricted edges; its own
time is reported beside its bytes bound and its chain bound (the longest
row's dependent adds at the SM clock nvidia-smi reads during the
timing), with the grouping's build time and its own time by warp-row
threshold.  The kernels'
launch counters are set to 0
just before each path and read just after it; each path must launch each
kernel exactly as often as its blocks demand.  A distributed job's
processes run under this script's counting wrapper (``chip_smoke.py
--counted-child LOG MODULE ARGS``), which appends each process's counts
to LOG as it ends (a ``--serve`` worker appends after each command that
launched a kernel, so a worker killed -9 keeps its finished commands'
counts); LOG is emptied just before the job and read just after it.  The ``kernels`` line
reports each kernel's count on its CLI path as ``launches`` and every
path's in ``launches_by_path``.

The times phase reports, per kernel, the wall time of a call, its device
ops and their device time as the profiler records them, and the kernel's
own device time; a call of the tokenizer or of the fused pre-aggregation
must be one device op.  Kernel B is timed at the WordCount fold's, a
block's and the tf fold's shapes, kernel C at the block shape and at the
``run_stream`` segment shape.

Output: one line per check, the card's name and power limit, one JSON
line with each kernel's numbers (and the MB/s of the runners and apps,
the pagerank report, the Zipf runs, the roofline rows and the
attribution joins), and last a JSON line
``{"ok": true, "device": {...}}``.  Every phase raises on failure, so the
script exits non-zero and prints no result; it also refuses to run
without CUDA or without the ``locust_tpu_torch`` package beside it.
Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(HERE, "data", "sample_corpus.txt")
TARGET_BYTES = 32 << 20

# H100 SXM peaks from NVIDIA's data sheet (dense, at the 700 W limit):
# HBM bytes per second, and the float32 rate outside the tensor cores,
# used for int32 compare-exchanges (the data sheet states no int32 rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# The oracle's delimiter set, written out here so it does not come from
# the code under test: the reference's strtok set plus NUL and CR/LF.
_SPLIT = re.compile(b"[" + re.escape(b" ,.-;:'()\"\t" + b"\n\r\x00") + b"]+")


def log(*parts) -> None:
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"== {name}: done in {time.perf_counter() - t0:.3f} s")


def analysis_phase() -> dict:
    """The port's static invariant gate on this host (which has no jax):
    ``python -m locust_tpu_torch.analysis --json`` must exit 0.  Logs the
    rule count, the findings and the seconds; any failure raises."""
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "locust_tpu_torch.analysis", "--json"],
                         cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"static analysis exited {out.returncode}: "
                             f"{out.stdout[-4000:]}{out.stderr[-2000:]}")
    res = json.loads(out.stdout)
    row = {"rules": len(res["rules"]), "files": res["files"], "findings": res["total"],
           "new": res["new"], "suppressed": res["suppressed"], "seconds": round(seconds, 3)}
    log(f"  {row['rules']} rules over {row['files']} files: {row['findings']} findings "
        f"({row['new']} new), {row['suppressed']} suppressed with a reason, "
        f"{seconds:.3f} s (process included)")
    return row


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of one call of ``fn`` over ``reps`` back-to-back calls,
    CUDA events around them, after ``warmup`` calls.  Where the host
    dispatches slower than the device runs, this is the dispatch time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_events(torch, fn) -> list:
    """The device-side ops of ``fn()`` as ``torch.profiler`` records them
    (empty when it records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(torch, fn, reps: int = 20) -> float | None:
    """Device time of one call of ``fn``: the summed durations of the
    device ops of ``reps`` calls, over ``reps``.  Unlike ``cuda_ms`` it
    leaves out the host's dispatch time; None when nothing was recorded."""
    fn()
    torch.cuda.synchronize()
    ops = device_events(torch, lambda: [fn() for _ in range(reps)])
    return sum(e.time_range.elapsed_us() for e in ops) / reps / 1e3 if ops else None


def call_profile(torch, fn, kernel: str, reps: int = 20) -> tuple[float, float, float]:
    """Per call of ``fn``, from ``torch.profiler``: its device ops, their
    summed device time (ms) and the device time (ms) of the events whose
    name holds ``kernel``, the kernel's own.  The calls are counted from a
    host-to-device copy on: the profiler misses the first few device ops
    of a recording, so 50 calls before the copy take them.  Raises when
    the profiler records no device time."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        torch.ones(1).to("cuda")  # the marker
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()

    for _ in range(3):  # a recording may come back empty: try again
        ev = device_events(torch, run)
        marks = [e.time_range.start for e in ev if "Memcpy" in e.name]
        if marks and any(kernel in e.name for e in ev):
            break
        log(f"  {kernel}: the profiler recorded {len(ev)} device ops "
            f"({sorted({e.name[:40] for e in ev})}) and no marker; again")
    else:
        raise AssertionError(f"{kernel}: the profiler recorded no device time")
    ops = [e for e in ev if e.time_range.start > max(marks)]
    total = sum(e.time_range.elapsed_us() for e in ops) / reps / 1e3
    own = sum(e.time_range.elapsed_us() for e in ops if kernel in e.name) / reps / 1e3
    return len(ops) / reps, total, own


def _ms(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def oracle_wordcount(lines, line_width: int, emits: int, key_width: int) -> collections.Counter:
    """strtok semantics with the engine's caps: rows cut to line_width,
    at most ``emits`` tokens per line, keys cut to key_width."""
    per_line = collections.Counter(lines)
    out = collections.Counter()
    for line, times in per_line.items():
        toks = [t for t in _SPLIT.split(line[:line_width]) if t][:emits]
        for t in toks:
            out[t[:key_width]] += times
    return out


def replicated_corpus(target_bytes: int) -> tuple[list[bytes], int]:
    with open(CORPUS, "rb") as f:
        base = f.read().splitlines()
    lines, total = [], 0
    while total < target_bytes:
        for ln in base:
            lines.append(ln)
            total += len(ln) + 1
            if total >= target_bytes:
                break
    return lines, total


def oracle_docs(lines, lines_per_doc: int, line_width: int, emits: int, key_width: int):
    """The apps' oracle over line-sharded documents (doc id of line i is
    ``i // lines_per_doc``), with the engine's caps: the (word, doc)
    counts and the number of documents."""
    tf = collections.Counter()
    for i, line in enumerate(lines):
        doc = i // lines_per_doc
        for t in [t for t in _SPLIT.split(line[:line_width]) if t][:emits]:
            tf[t[:key_width], doc] += 1
    return tf, -(-len(lines) // lines_per_doc)


def render_postings(tf) -> bytes:
    """``index``'s stdout: each word with its sorted doc set."""
    docs = collections.defaultdict(set)
    for word, doc in tf:
        docs[word].add(doc)
    return b"".join(w + b"\t" + b",".join(str(d).encode() for d in sorted(docs[w])) + b"\n"
                    for w in sorted(docs))


def render_tfidf(tf, n_docs: int) -> bytes:
    """``tfidf``'s stdout: ``count * ln(n_docs / df)`` in float64."""
    df = collections.Counter(word for word, _ in tf)
    return b"".join(
        w + b"\t" + str(d).encode() + b"\t"
        + f"{tf[w, d] * math.log(n_docs / df[w]):.6f}".encode() + b"\n"
        for w, d in sorted(tf))


def synthetic_web_graph(seed: int = 20):
    """A seeded edge list at web-Google's published scale (875,713 nodes,
    5,105,039 edges): sources drawn with Pareto(2.0) weights over the
    nodes that are not made dangling (12% are; more end up with no edge),
    destinations with Pareto(1.5) weights, so both degrees are skewed."""
    rng = np.random.default_rng(seed)
    n, e = 875_713, 5_105_039
    out_w = rng.pareto(2.0, n) + 1.0
    out_w[rng.random(n) < 0.12] = 0.0
    src = rng.choice(n, e, p=out_w / out_w.sum())
    in_w = rng.pareto(1.5, n) + 1.0
    dst = rng.choice(n, e, p=in_w / in_w.sum())
    return n, src, dst


def pagerank_oracle(src, dst, n: int, num_iters: int, damping: float) -> np.ndarray:
    """The power iteration in float64 numpy, written out here."""
    deg = np.bincount(src, minlength=n).astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    dangling = deg == 0
    ranks = np.full(n, 1.0 / n)
    for _ in range(num_iters):
        contrib = np.bincount(dst, weights=ranks[src] * inv[src], minlength=n)
        ranks = (1.0 - damping) / n + damping * (contrib + ranks[dangling].sum() / n)
    return ranks


def plan_phase(env) -> None:
    """WordCount through the compiled plan under hasht: the optimizer's
    fuse_fold_kernel rewrite must send every block through kernel C."""
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.plan import optimize, wordcount_plan

    with phase("WordCount through the compiled plan: the CLI under --sort-mode hasht"):
        applied = optimize(wordcount_plan(), EngineConfig(sort_mode="hasht")).applied
        if applied != ("fuse_fold_kernel",):
            raise AssertionError(f"the optimizer applied {applied} under hasht")
        out = env.run_cli("cli_hasht", [env.corpus_file, "--sort-mode", "hasht", "--no-timing",
                                        *env.cli_extra])
        env.expected["cli_hasht"] = {"tokenize": 0, "bitonic_sort": 0, "fused_fold": env.nblocks}
        if out != env.want:
            raise AssertionError("CLI --sort-mode hasht stdout differs from the oracle")
        log(f"  CLI --sort-mode hasht --no-timing: plan rewrites {list(applied)}, "
            "stdout == oracle")
        env.check_counts("cli_hasht")


def apps_phase(env) -> dict:
    """``index`` and ``tfidf`` over the corpus file, one document per
    block, byte for byte against the oracle; MB/s of each app's plan run
    over rows loaded beforehand."""
    from locust_tpu_torch.plan import index_plan, tfidf_plan
    from locust_tpu_torch.plan.compile import compile_plan

    lpd = env.BL
    app_mbs = {}
    with phase(f"the apps: index and tfidf over the corpus file, --lines-per-doc {lpd}"):
        tf, n_docs = oracle_docs(env.lines, lpd, env.W, env.E, env.K)
        want = {"index": render_postings(tf), "tfidf": render_tfidf(tf, n_docs)}
        env.postings_want = want["index"]  # index --mesh prints it too
        log(f"  oracle: {n_docs} docs, {len(tf)} distinct (word, doc) pairs, "
            f"{len({w for w, _ in tf})} distinct words")
        for app, mode, sorts in (("index", "bitonic", 0), ("tfidf", "bitonic", env.nblocks)):
            name = f"cli_{app}"
            t0 = time.perf_counter()
            out = env.run_cli(name, [app, env.corpus_file, "--lines-per-doc", str(lpd),
                                     "--sort-mode", mode, *env.cli_extra])
            if app == "index":  # the mesh apps' phase holds index --mesh beside it
                env.index_single = (out, time.perf_counter() - t0)
            got_rows, want_rows = out.count(b"\n"), want[app].count(b"\n")
            if out != want[app]:
                raise AssertionError(f"{app}: stdout differs from the oracle "
                                     f"({got_rows} vs {want_rows} rows)")
            env.expected[name] = {"tokenize": env.nblocks, "bitonic_sort": sorts, "fused_fold": 0}
            log(f"  {app} --sort-mode {mode}: stdout == oracle ({got_rows} rows, "
                f"{len(out)} bytes)")
        env.check_counts("cli_index", "cli_tfidf")
        # Every word is in every doc here, so every score is 0: hold the
        # tf table itself against the oracle's counts as well.
        from locust_tpu_torch.apps.tfidf import term_doc_counts

        ids = (np.arange(len(env.lines)) // lpd).astype(np.int32)
        got_tf = term_doc_counts(env.rows, ids, env.cfg, device=env.dev)
        if got_tf != dict(tf):
            raise AssertionError(f"term_doc_counts differs from the oracle ({len(got_tf)} vs "
                                 f"{len(tf)} pairs)")
        log(f"  term_doc_counts: {len(got_tf)} (word, doc) counts == oracle")
        for app, plan in (("index", index_plan(lpd)), ("tfidf", tfidf_plan(lpd))):
            cp = compile_plan(plan, env.cfg, device=env.dev)
            cp.run(env.rows[: 2 * env.BL], render=False)  # first-call warm-up
            m, runs = env.median_s(lambda: cp.run(env.rows, render=False))
            app_mbs[app] = env.corpus_bytes / m / 1e6
            log(f"  {app} plan run over rows in memory, 3 runs: median {m * 1e3:.3f} ms, "
                f"{app_mbs[app]:.3f} MB/s; runs ms {[round(r * 1e3, 3) for r in runs]}")
            if env.dev.type == "cuda":
                profile_breakdown(env.torch, lambda: cp.run(env.rows[: 8 * env.BL], render=False),
                                  f"{app} plan run, 8 blocks", 8, "block")
    return app_mbs


def profile_breakdown(torch, fn, what: str, n: int, unit: str) -> None:
    """Device ops per ``unit``, the busy share of the device window and
    the top kernels by device time, from ``torch.profiler`` over ``fn``."""
    kern = device_events(torch, fn)
    if not kern:
        log(f"  {what}: the profiler recorded no device time: busy share not measured")
        return
    span = max(k.time_range.end for k in kern) - min(k.time_range.start for k in kern)
    by_name = collections.Counter()
    for k in kern:
        by_name[k.name[:70]] += k.time_range.elapsed_us()
    busy = sum(by_name.values())
    log(f"  {what}: {len(kern)} device ops ({len(kern) / n:g} per {unit}), busy "
        f"{busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms device window: busy share {busy / span:.3f}")
    for name, us in by_name.most_common(8):
        log(f"  {us / 1e3:9.3f} ms  {us / busy:6.1%}  {name}")


def pagerank_phase(env) -> dict:
    """``pagerank`` over a synthetic graph at web-Google's scale: the CLI
    on the card and on the CPU, which must print the same bytes (every
    step adds each node's contributions in edge order: the gather-add
    kernel on the card, ``index_add_`` on the CPU), the largest |delta
    rank| against a float64 oracle, iterations per second; and the
    gather-add kernel held bit for bit against its plain version (the CSR
    walk as torch ops) on the card at both index widths and on a
    dst-restricted subset, with its own time, its two bounds, the
    grouping's build time and ``index_add_``'s time."""
    from locust_tpu_torch.apps.pagerank import pagerank

    iters, damping = 20, 0.85
    with phase("pagerank over a seeded edge list at web-Google's scale, 20 iterations"):
        n, src, dst = synthetic_web_graph()
        path = os.path.join(env.work, "edges.txt")
        with open(path, "wb") as f:
            f.write("".join(f"{a}\t{b}\n" for a, b in zip(src.tolist(), dst.tolist())).encode())
        deg = np.bincount(src, minlength=n)
        max_in = int(np.bincount(dst, minlength=n).max())
        log(f"  {n} nodes, {len(src)} edges, {int((deg == 0).sum())} dangling nodes, "
            f"max out-degree {int(deg.max())}, max in-degree {max_in}")
        argv = ["pagerank", path, "--num-nodes", str(n), "--num-iters", str(iters)]
        t0 = time.perf_counter()
        out_dev = env.run_cli("cli_pagerank", argv + env.cli_extra)
        single_s = time.perf_counter() - t0
        out_cpu = env.run_cli("cli_pagerank_cpu", argv + ["--backend", "cpu"])
        # One gather-add per iteration on the card; the CPU's plain version
        # is no launch.
        env.expected["cli_pagerank"] = {"pagerank": iters if env.dev.type == "cuda" else 0}
        env.expected["cli_pagerank_cpu"] = {}
        rows_dev, rows_cpu = out_dev.splitlines(), out_cpu.splitlines()
        if len(rows_dev) != n or len(rows_cpu) != n:
            raise AssertionError(f"pagerank printed {len(rows_dev)} and {len(rows_cpu)} rows, "
                                 f"expected {n}")
        differ = sum(a != b for a, b in zip(rows_dev, rows_cpu))
        r_dev = pagerank(src, dst, n, iters, damping, device=env.dev).cpu().numpy()
        r_cpu = pagerank(src, dst, n, iters, damping, device="cpu").numpy()
        oracle = pagerank_oracle(src, dst, n, iters, damping)
        printed = np.array([float(r.split(b"\t")[1]) for r in rows_dev])
        if not (np.isfinite(r_dev).all() and r_dev.shape == (n,)):
            raise AssertionError("pagerank: ranks not finite or of the wrong shape")
        d_oracle = float(np.abs(r_dev - oracle).max())
        d_cpu = float(np.abs(r_dev.astype(np.float64) - r_cpu).max())
        d_cpu_oracle = float(np.abs(r_cpu - oracle).max())
        d_printed = float(np.abs(printed - oracle).max())
        # float32 ranks after 20 sums over up to 10^4 in-edges: within
        # 1e-5 of the largest rank of the float64 oracle; the printed
        # values (the CLI's own run) as well, give or take their 8 decimals.
        tol = 1e-5 * float(oracle.max())
        if d_oracle > tol or d_cpu_oracle > tol or d_printed > tol + 5e-9:
            raise AssertionError(f"pagerank: |delta| {d_oracle:.3e} (card) / {d_cpu_oracle:.3e} "
                                 f"(CPU) / {d_printed:.3e} (printed) against the oracle, "
                                 f"above {tol:.3e}")
        # The card adds in the CPU's order: the same bits, the same bytes.
        if differ or d_cpu != 0.0 or out_dev != out_cpu:
            raise AssertionError(f"pagerank: the card differs from the CPU: {differ} printed "
                                 f"lines, max |delta| {d_cpu:.3e}")
        env.check_counts("cli_pagerank", "cli_pagerank_cpu")
        # The mesh apps' phase runs pagerank --mesh over the same file and
        # holds it beside this run of the single-device CLI.
        env.pagerank_graph = (n, src, dst, path, oracle)
        env.pagerank_single = (out_dev, single_s)
        pagerank(src, dst, n, 1, damping, device=env.dev)  # warm-up
        m, runs = env.median_s(lambda: pagerank(src, dst, n, iters, damping, device=env.dev))
        out = {"nodes": n, "edges": int(len(src)), "iters": iters, "max_in_degree": max_in,
               "max_abs_delta_vs_float64_oracle": d_oracle,
               "max_abs_delta_cpu_vs_float64_oracle": d_cpu_oracle,
               "max_abs_delta_vs_cpu_run": d_cpu, "printed_lines_differing_from_cpu": differ,
               "max_abs_delta_printed_vs_float64_oracle": d_printed,
               "iters_per_s": iters / m, "run_ms": m * 1e3,
               "rank_sum": float(r_dev.astype(np.float64).sum())}
        log(f"  card vs float64 oracle: max |delta| {d_oracle:.6e}; CPU run vs oracle "
            f"{d_cpu_oracle:.6e}; card vs CPU run {d_cpu:.6e}; the card CLI's printed ranks "
            f"vs oracle {d_printed:.6e} (tolerance {tol:.3e}); "
            f"printed lines differing from the CPU CLI: {differ} of {n}; sum of ranks "
            f"{out['rank_sum']:.9f}")
        log(f"  pagerank on the card, 3 runs of {iters} iterations: median {m * 1e3:.3f} ms, "
            f"{iters / m:.3f} iterations/s; runs ms {[round(r * 1e3, 3) for r in runs]}")
        if env.dev.type == "cuda":
            out["kernel"] = gather_add_report(env, n, src, dst, max_in)
    return out


def gather_add_report(env, n: int, src, dst, max_in: int) -> dict:
    """The gather-add kernel alone at a graph's shape, on a seeded rank
    vector: its int32 grouping (the main path's), the same forced to int64
    (the other instantiation) and a pool rank shard's dst-restricted
    subset (most rows empty), each bit for bit against the CSR walk; its
    times, its bounds, the grouping's build time and a sweep of the
    warp-row threshold."""
    from locust_tpu_torch.apps.pagerank import pagerank_grouping, pagerank_prep
    from locust_tpu_torch.ops.kernels.pagerank import (WARP_ROW_THRESHOLD, csr_walk_reference,
                                                       gather_add, in_edges)
    from locust_tpu_torch.plan.distribute import shard_ranges
    from locust_tpu_torch.utils import roofline

    torch, dev = env.torch, env.dev
    inv_deg, _ = pagerank_prep(src, n, dev)
    s_t = torch.from_numpy(src).to(dev)
    d_t = torch.from_numpy(dst).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grouping = pagerank_grouping(s_t, d_t, n, dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    ranks = torch.from_numpy(np.random.default_rng(4).random(n).astype(np.float32) / n).to(dev)
    init = torch.tensor(np.float32(0.3) / np.float32(n), device=dev)
    lo, hi = shard_ranges(n, 2)[0]
    keep = (d_t >= lo) & (d_t < hi)
    groupings = {"int32": grouping, "int64": in_edges(s_t, d_t, n, dtype=torch.int64),
                 "dst-restricted": in_edges(s_t[keep], d_t[keep], n)}

    def kernel(g=grouping):
        return gather_add(init, *g, ranks, inv_deg)

    def plain(g=grouping):
        return csr_walk_reference(init, *g, ranks, inv_deg)

    def library():
        return init.expand(n).clone().index_add_(0, d_t, ranks[s_t] * inv_deg[s_t])

    err = 0.0
    for name, g in groupings.items():
        got, want = kernel(g), plain(g)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"pagerank gather-add kernel ({name} grouping) differs "
                                 f"from its plain version: max abs err {e}")
        err = max(err, e)
        log(f"  gather-add, {name} grouping ({g.offsets.dtype}, {g.src_by_dst.shape[0]} "
            f"edges, {g.warp_rows} warp rows): == plain (CSR walk) bit for bit")
    k_ms = cuda_ms(torch, kernel)
    p_ms = cuda_ms(torch, plain, reps=3, warmup=1)
    l_ms = cuda_ms(torch, library)
    k_ops, k_dev, k_own = call_profile(torch, kernel, "gather_add_kernel")
    l_dev = device_ms(torch, library)
    clock = sm_clock_mhz(torch, kernel)
    ops = roofline.pagerank_gather_min_ops(len(src))
    # The bytes at the index width the kernel takes (int32 here), and
    # at int64; the chain: the longest row's dependent adds.
    b, by = bound_ms(roofline.pagerank_gather_min_bytes(n, len(src), index_bytes=4), ops)
    b64, _ = bound_ms(roofline.pagerank_gather_min_bytes(n, len(src)), ops)
    chain = roofline.pagerank_chain_min_ms(max_in, clock)
    larger = max(b, chain)
    # The warp-row threshold against the kernel's own device time.
    sweep = {}
    for t in (8, 16, 32, 64, 128):
        g = in_edges(s_t, d_t, n, threshold=t)
        sweep[t] = {"warp_rows": g.warp_rows,
                    "device_ms": device_ms(torch, lambda g=g: kernel(g))}
    report = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                     "library_device_ms": l_dev, "device_ms": k_dev,
                     "kernel_device_ms": k_own, "device_ops_per_call": k_ops,
                     "bound_ms": b, "bound_by": by, "bound_int64_ms": b64,
                     "chain_bound_ms": chain, "sm_clock_mhz": clock,
                     "larger_bound": "chain" if chain > b else by,
                     "share_of_larger_bound": larger / k_own,
                     "warp_rows": grouping.warp_rows,
                     "warp_row_threshold": WARP_ROW_THRESHOLD,
                     "grouping_build_ms": build_ms,
                     "threshold_sweep": sweep,
                     "shape": f"{n} nodes, {len(src)} edges, max in-degree {max_in}, "
                              f"int32 indices"}
    log(f"  gather-add kernel at {report['shape']}: kernel {k_ms:.4f} ms, "
        f"{k_ops:g} device ops per call, device {k_dev:.4f} ms, the kernel's own "
        f"{k_own:.4f} ms; plain {p_ms:.4f} ms; index_add_ {l_ms:.4f} ms (device "
        f"{_ms(l_dev)}); card {env.smi}")
    log(f"  gather-add bounds: bytes {b:.6f} ms at int32 ({b / k_own:.4f} of it), "
        f"{b64:.6f} ms at int64; chain {chain:.6f} ms ({max_in} dependent adds x "
        f"{roofline.FADD_DEPENDENT_CYCLES} cycles at {clock:g} MHz, nvidia-smi clocks.sm "
        f"beside the timing); the larger, {report['larger_bound']}: "
        f"{larger / k_own:.4f} of it")
    log(f"  gather-add grouping: built in {build_ms:.3f} ms (offsets, sources, schedule); "
        f"{grouping.warp_rows} warp rows of more than {WARP_ROW_THRESHOLD} in-edges, "
        f"{n - grouping.warp_rows} thread rows; own device ms by warp-row threshold: "
        + ", ".join(f"{t}: {_ms(v['device_ms'])} ({v['warp_rows']} warp rows)"
                    for t, v in sweep.items()))
    if k_ops != 1:
        raise AssertionError(f"a gather-add call is {k_ops:g} device ops, not 1")
    return report


def sm_clock_mhz(torch, fn) -> float:
    """The SM clock (MHz) as ``nvidia-smi --query-gpu=clocks.sm`` reads it
    while ``fn`` runs back to back on the card."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits"],
                            stdout=subprocess.PIPE, text=True)
    try:
        while proc.poll() is None:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        return float(proc.communicate(timeout=60)[0].split()[0])
    finally:
        if proc.poll() is None:
            proc.kill()


def trace_phase(env) -> None:
    """``--trace-out`` on WordCount (staged report, and --stream) and on
    tfidf: each file validates against the port's schema and holds the
    spans of its path."""
    from locust_tpu_torch.obs.schema import validate_trace

    with phase("--trace-out: WordCount, WordCount --stream and tfidf, 16 blocks"):
        sub = env.lines[: 16 * env.BL]
        path = os.path.join(env.work, "sub.txt")
        with open(path, "wb") as f:
            f.write(b"\n".join(sub) + b"\n")
        want = b"".join(k + b"\t" + str(v).encode() + b"\n"
                        for k, v in sorted(oracle_wordcount(sub, env.W, env.E, env.K).items()))
        tf, n_docs = oracle_docs(sub, env.BL, env.W, env.E, env.K)
        stage = {"plan.compile", "plan.run", "cli.load", "cli.run", "cli.output",
                 "engine.stage.map", "engine.stage.process", "engine.stage.reduce",
                 "engine.stage.merge"}
        runs = (
            ("cli_trace_wordcount", [path], want, stage,
             {"tokenize": 16, "bitonic_sort": 32, "fused_fold": 0}),
            ("cli_trace_stream", [path, "--stream"], want,
             {"plan.compile", "stream.block", "stream.stall", "cli.run"},
             {"tokenize": 16, "bitonic_sort": 16, "fused_fold": 0}),
            ("cli_trace_tfidf", ["tfidf", path, "--lines-per-doc", str(env.BL)],
             render_tfidf(tf, n_docs), {"plan.compile", "plan.optimize", "plan.run"},
             {"tokenize": 16, "bitonic_sort": 16, "fused_fold": 0}),
        )
        for name, argv, want_out, need, counts in runs:
            trace = os.path.join(env.work, f"{name}.trace.json")
            out = env.run_cli(name, argv + ["--trace-out", trace, *env.cli_extra])
            if out != want_out:
                raise AssertionError(f"{name}: stdout differs from the oracle")
            with open(trace, encoding="utf-8") as f:
                doc = json.load(f)
            validate_trace(doc)
            names = collections.Counter(e["name"] for e in doc["traceEvents"] if e["ph"] != "M")
            if not need <= set(names):
                raise AssertionError(f"{name}: the trace lacks {sorted(need - set(names))}")
            env.expected[name] = counts
            metrics = doc["otherData"].get("metrics", {})
            log(f"  {name}: stdout == oracle; trace validates, {sum(names.values())} "
                f"records: {dict(sorted(names.items()))}; metrics {json.dumps(metrics)}")
        env.check_counts(*(r[0] for r in runs))


def native_reader_phase(env) -> None:
    """The native reader (csrc/ingest.cpp, built with g++) against the
    Python reader, byte for byte on the corpus file: ``load_rows``,
    ``StreamingCorpus`` blocks and ``measure_caps_stream``; and each
    one's ``load_rows`` MB/s."""
    from locust_tpu_torch.io import loader

    with phase("the native reader against the Python reader on the corpus file"):
        got = {}
        for native in (True, False):
            t0 = time.perf_counter()
            got[native] = loader.load_rows(env.corpus_file, env.W, use_native=native)
            s = time.perf_counter() - t0
            log(f"  load_rows ({'native' if native else 'Python'}): {got[native].shape[0]} rows "
                f"in {s * 1e3:.3f} ms, {env.corpus_bytes / s / 1e6:.3f} MB/s")
        if not (np.array_equal(got[True], got[False]) and np.array_equal(got[True], env.rows)):
            raise AssertionError("load_rows: the native rows differ from the Python rows")
        blocks = {n: list(loader.StreamingCorpus(env.corpus_file, env.W, env.BL, use_native=n))
                  for n in (True, False)}
        if len(blocks[True]) != len(blocks[False]) or not all(
                np.array_equal(a, b) for a, b in zip(blocks[True], blocks[False])):
            raise AssertionError("StreamingCorpus: the native blocks differ from the Python blocks")
        caps = {n: loader.measure_caps_stream(
            loader.StreamingCorpus(env.corpus_file, env.W, env.BL, use_native=n))
            for n in (True, False)}
        if caps[True] != caps[False]:
            raise AssertionError(f"measure_caps_stream: native {caps[True]} != Python {caps[False]}")
        log(f"  load_rows, {len(blocks[True])} StreamingCorpus blocks and measure_caps_stream "
            f"{caps[True]}: native == Python, byte for byte")


def read_tsv_check(path: str, key_width: int) -> int:
    """``read_tsv`` of a stage-1 intermediate: native == Python."""
    from locust_tpu_torch.io import serde

    nk, nv = serde.read_tsv(path, key_width)
    pk, pv = serde.read_tsv(path, key_width, use_native=False)
    if not (np.array_equal(nk, pk) and np.array_equal(nv, pv)):
        raise AssertionError(f"read_tsv of {path}: native differs from Python")
    return len(nv)


def attribution_phase(env) -> dict:
    """``attributed_run`` over ``timed_run`` under bitonic, hasht and
    fused, and over ``run_fused`` under fused (kernel C): no error, a
    Process device time, the Process-stage spans annotated; kernel B's
    and kernel C's entry symbols counted in their families; the CLI's
    ``--profile-dir`` leaves a trace."""
    from locust_tpu_torch import obs
    from locust_tpu_torch.engine import MapReduceEngine
    from locust_tpu_torch.obs.attribution import PROCESS_STAGE_SPAN, attributed_run
    from locust_tpu_torch.utils import profiling

    nb = 16
    sub_lines = env.lines[: nb * env.BL]
    sub = env.rows[: nb * env.BL]
    want = sorted(oracle_wordcount(sub_lines, env.W, env.E, env.K).items())
    families = {"sort": (profiling.SORT_OP_FRAGMENTS, profiling.FUSED_KERNEL_OP_FRAGMENTS),
                "scatter": (profiling.SCATTER_OP_FRAGMENTS, ()),
                "dot": (profiling.DOT_OP_FRAGMENTS, ()),
                "kernel": (profiling.FUSED_KERNEL_OP_FRAGMENTS, ())}

    def family_of(name):
        return [f for f, (frags, excl) in families.items()
                if profiling.family_ms({name: 1.0}, frags, excl) == 1.0]

    joins = {}
    with phase(f"attribution: attributed_run over timed_run ({nb} blocks) under bitonic, hasht "
               "and fused, and over run_fused under fused"):
        runs = [("timed_run", m) for m in ("bitonic", "hasht", "fused")] + [("run_fused", "fused")]
        for runner, mode in runs:
            eng = MapReduceEngine(dataclasses.replace(env.cfg, sort_mode=mode), device=env.dev)
            getattr(eng, runner)(sub[: 2 * env.BL])  # warm-up, outside the capture
            tracer = obs.enable(process="chip_smoke")
            try:
                res, summary, path, join = attributed_run(
                    lambda: getattr(eng, runner)(sub),
                    os.path.join(env.work, f"prof_{runner}_{mode}"), mode)
                events = tracer.to_chrome()["traceEvents"]
            finally:
                obs.disable()
            name = f"{runner} {mode}"
            if "error" in join or join["process_device_ms"] is None:
                raise AssertionError(f"attribution of {name}: {join}")
            if res.to_host_pairs() != want:
                raise AssertionError(f"attribution of {name}: host pairs differ from the oracle")
            annotated = sum(1 for e in events if e["name"] == PROCESS_STAGE_SPAN
                            and "process_family" in e.get("args", {}))
            if runner == "timed_run" and annotated != nb:
                raise AssertionError(f"attribution of {name}: {annotated} Process spans "
                                     f"annotated, expected {nb}")
            if env.dev.type == "cuda" and join["device_plane"] != "cuda":
                raise AssertionError(f"attribution of {name}: device plane {join['device_plane']}")
            with open(path, encoding="utf-8") as f:
                kernels = collections.Counter(
                    e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel")
            for kname, fam in (("bitonic_", "sort"), ("fused_preagg", "kernel")):
                for k in kernels:
                    if kname in k and family_of(k) != [fam]:
                        raise AssertionError(f"{k} falls in {family_of(k)}, not [{fam!r}]")
            if env.dev.type == "cuda":
                if (mode, runner) == ("bitonic", "timed_run") and not any(
                        "bitonic_" in k for k in kernels):
                    raise AssertionError("no kernel B launch in the bitonic capture")
                if (mode, runner) == ("fused", "run_fused") and not (
                        any("fused_preagg" in k for k in kernels) and join["kernel_device_ms"] > 0):
                    raise AssertionError("kernel C is not in the fused capture's kernel family")
            joins[name] = join
            log(f"  {name}: {json.dumps(join)}; {annotated} Process spans annotated; "
                f"{sum(kernels.values())} kernel launches in the trace")
        trace_dir = os.path.join(env.work, "cli_profile")
        path = os.path.join(env.work, "sub16.txt")
        with open(path, "wb") as f:
            f.write(b"\n".join(sub_lines) + b"\n")
        out = env.run_cli("cli_profile_dir", [path, "--profile-dir", trace_dir, *env.cli_extra])
        env.expected["cli_profile_dir"] = {"tokenize": nb, "bitonic_sort": 2 * nb, "fused_fold": 0}
        if out != b"".join(k + b"\t" + str(v).encode() + b"\n" for k, v in want):
            raise AssertionError("CLI --profile-dir: stdout differs from the oracle")
        found = [n for n in os.listdir(trace_dir) if n.endswith(profiling.TRACE_SUFFIX)]
        if len(found) != 1:
            raise AssertionError(f"CLI --profile-dir left {found}")
        summary = profiling.parse_trace(os.path.join(trace_dir, found[0]))
        if "error" in summary:
            raise AssertionError(f"CLI --profile-dir: {summary['error']}")
        env.check_counts("cli_profile_dir")
        log(f"  CLI --profile-dir: stdout == oracle; {found[0]}: plane {summary['device_plane']}, "
            f"{summary['device_total_ms']} ms, sort {summary['sort_ms']} ms")
    return joins


def debug_faults_phase(env) -> None:
    """``LOCUST_DEBUG_CHECKS=1`` over ``run_fused`` under bitonic and
    hasht; ``run_checkpointed`` crashed by an ``io.ckpt_write`` plan and
    resumed; a crash of the background writer under ``run_stream``; and
    every published snapshot truncated by an ``io.checkpoint`` plan, then
    a clean restart.  Each run oracle-exact, with its launch counts."""
    from locust_tpu_torch.engine import MapReduceEngine
    from locust_tpu_torch.io.loader import StreamingCorpus
    from locust_tpu_torch.state import load_jax_checkpoint
    from locust_tpu_torch.utils import faultplan

    n = env.nblocks
    with phase("LOCUST_DEBUG_CHECKS=1: run_fused under bitonic and hasht"):
        os.environ["LOCUST_DEBUG_CHECKS"] = "1"
        try:
            for mode in ("bitonic", "hasht"):
                eng = MapReduceEngine(dataclasses.replace(env.cfg, sort_mode=mode),
                                      device=env.dev)
                name = f"debug_checks_{mode}"
                res, env.by_path[name] = env.counted(lambda: eng.run_fused(env.rows))
                env.expected[name] = {"tokenize": n, "bitonic_sort": n if mode == "bitonic" else 0,
                                      "fused_fold": 0}
                env.check_pairs(name, res, env.oracle)
                log(f"  {name}: the table passed validate_batch; pairs == oracle")
        finally:
            del os.environ["LOCUST_DEBUG_CHECKS"]
        env.check_counts("debug_checks_bitonic", "debug_checks_hasht")

    with phase("fault plans: io.ckpt_write crash then resume; writer crash under run_stream; "
               "io.checkpoint truncate then clean restart"):
        eng = MapReduceEngine(dataclasses.replace(env.cfg, async_checkpoint=False),
                              device=env.dev)
        ck = os.path.join(env.work, "fault_crash")
        plan = faultplan.FaultPlan(
            [{"site": "io.ckpt_write", "action": "crash", "after": 3, "times": 1}], seed=7)
        with faultplan.active_plan(plan):
            try:
                eng.run_checkpointed(env.rows, ck, every=8)
            except faultplan.FaultCrash as e:
                log(f"  run_checkpointed under the crash plan: {e}")
            else:
                raise AssertionError("the io.ckpt_write crash did not stop run_checkpointed")
        start = load_jax_checkpoint(os.path.join(ck, "state.npz"), "cpu").next_block
        res, env.by_path["fault_resumed"] = env.counted(
            lambda: eng.run_checkpointed(env.rows, ck, every=8))
        env.check_pairs("fault_resumed", res, env.oracle)
        env.expected["fault_resumed"] = {"tokenize": n - start, "bitonic_sort": n - start,
                                         "fused_fold": 0}
        if start != 24:
            raise AssertionError(f"the surviving snapshot is at block {start}, expected 24")
        log(f"  resumed from the surviving snapshot at block {start}: pairs == oracle")

        fe = MapReduceEngine(dataclasses.replace(env.cfg, sort_mode="fused"), device=env.dev)
        stream = StreamingCorpus(env.corpus_file, env.W, env.BL)
        plan = faultplan.FaultPlan([{"site": "io.ckpt_write", "action": "crash", "times": 1}],
                                   seed=7)
        with faultplan.active_plan(plan):
            res = fe.run_stream(stream, checkpoint_dir=os.path.join(env.work, "fault_async"),
                                every=8, fingerprint=stream.fingerprint())
        env.check_pairs("run_stream under a writer crash", res, env.oracle)
        if res.stream["ckpt"]["abandoned"] != 1 or plan.rules[0].fired != 1:
            raise AssertionError(f"run_stream writer crash: {res.stream['ckpt']}")
        log(f"  run_stream (fused) with the background writer crashed once: pairs == oracle, "
            f"checkpoint {json.dumps(res.stream['ckpt'])}")

        ck = os.path.join(env.work, "fault_truncate")
        plan = faultplan.FaultPlan([{"site": "io.checkpoint", "action": "truncate"}], seed=7)
        with faultplan.active_plan(plan):
            res = eng.run_checkpointed(env.rows, ck, every=8)
        env.check_pairs("run_checkpointed under the truncate plan", res, env.oracle)
        res, env.by_path["fault_truncated_restart"] = env.counted(
            lambda: eng.run_checkpointed(env.rows, ck, every=8))
        env.check_pairs("fault_truncated_restart", res, env.oracle)
        env.expected["fault_truncated_restart"] = {"tokenize": n, "bitonic_sort": n,
                                                   "fused_fold": 0}
        log(f"  io.checkpoint truncated {plan.rules[0].fired} published snapshots: pairs == "
            "oracle; the rerun started afresh: pairs == oracle")
        env.check_counts("fault_resumed", "fault_truncated_restart")


DIST_SECRET = "chip-smoke-distributor"


def _counted(log_path: str, module: str) -> list[str]:
    """The command that runs ``module``'s ``main`` under ``_counted_child``."""
    return [sys.executable, os.path.abspath(__file__), "--counted-child", log_path, module]


# Set in a rehearsal on the CPU: a counted child then counts each call of
# a kernel's plain version as its launch, as the rehearsal's own process does.
COUNT_PLAIN_ENV = "CHIP_SMOKE_COUNT_PLAIN"


KERNELS = ("tokenize", "bitonic_sort", "fused_fold", "pagerank", "partition")


class _Expected(dict):
    """Each path's predicted launches; a kernel a path does not name is
    predicted 0 launches there."""

    def __init__(self, paths=()):
        super().__init__()
        for k, v in dict(paths).items():
            self[k] = v

    def __setitem__(self, path, counts):
        super().__setitem__(path, {**dict.fromkeys(KERNELS, 0), **counts})


def kernel_wrappers() -> dict:
    """Each kernel of ``KERNELS``: its module, the name of its plain version
    there, and its wrapper (whose ``launches`` counts its launches)."""
    from locust_tpu_torch.ops.kernels import fused_fold, pagerank, partition, sort, tokenize

    return {"tokenize": (tokenize, "tokenize_reference", tokenize.tokenize_block_kernel),
            "bitonic_sort": (sort, "bitonic_reference", sort.bitonic_sort_rows),
            "fused_fold": (fused_fold, "fused_preagg_reference", fused_fold.fused_block_preagg),
            "pagerank": (pagerank, "_plain", pagerank.gather_add),
            "partition": (partition, "_plain", partition.stable_partition)}


def _card_in_use():
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch
    return None


def _launch_counts() -> dict:
    """Each kernel wrapper's launch count in this process, and on the card
    the process's peak reserved device memory."""
    out = {name: w.launches for name, (_, _, w) in kernel_wrappers().items()}
    torch = _card_in_use()
    if torch is not None:
        out["max_memory_reserved"] = torch.cuda.max_memory_reserved()
    return out


def counted(fn):
    """Run ``fn`` with every launch counter set to 0 just before it;
    returns its result and the counts read just after it."""
    wrappers = kernel_wrappers()
    for _, _, w in wrappers.values():
        w.launches = 0
    out = fn()
    torch = _card_in_use()
    if torch is not None:
        torch.cuda.synchronize()
    return out, {name: w.launches for name, (_, _, w) in wrappers.items()}


def run_cli_counted(by_path: dict, name: str, argv) -> bytes:
    """The CLI as a user calls it, in this process: its stdout; the path's
    launch counts go to ``by_path[name]``."""
    from locust_tpu_torch import cli

    out = io.BytesIO()
    stdout = io.TextIOWrapper(out, write_through=True)
    with contextlib.redirect_stdout(stdout):
        rc, by_path[name] = counted(lambda: cli.main(argv))
    if rc != 0:
        raise AssertionError(f"{name}: the CLI exited {rc}")
    return out.getvalue()  # before the wrapper, and with it ``out``, is closed


def check_launches(by_path: dict, expected: dict, *names) -> None:
    """Each named path's launches equal its prediction.  A path counted in
    other processes reports the kernels its processes could launch; the
    others are 0 there."""
    for name in names:
        got = {**dict.fromkeys(KERNELS, 0), **by_path[name]}
        log(f"  launches in {name}: {got}, expected {expected[name]}")
        if got != expected[name]:
            raise AssertionError(f"{name} did not launch each kernel as its path must: "
                                 f"{got} != {expected[name]}")


def _count_plain_versions(patch=setattr) -> None:
    """Count a call of each kernel's plain version as a launch of its wrapper
    (the rehearsal on the CPU, where the wrappers launch nothing);
    ``patch`` sets each counting version in place (``setattr``, or a
    test's ``monkeypatch.setattr``)."""
    for mod, ref, wrapper in kernel_wrappers().values():
        def plain(*a, _ref=getattr(mod, ref), _w=wrapper, **k):
            _w.launches += 1
            return _ref(*a, **k)

        patch(mod, ref, plain)


_PARTITION_CHECKED: list | None = None


def _check_partition_calls() -> list:
    """Hold the partition kernel against its plain version on the CPU at
    the first call of each shape in this process, exactly: every word of
    the bins and the leftover, the overflow, each bin's total, and the
    payload in every filled bin slot.  Installed once a process on ``parallel/shuffle``'s
    reference to the wrapper, which every shuffle, index and sort path
    calls; a CPU call passes through.  Returns the list each checked shape
    (rows, lanes, bins, capacity, leftover capacity, payload words) goes
    to."""
    global _PARTITION_CHECKED
    if _PARTITION_CHECKED is not None:
        return _PARTITION_CHECKED
    from locust_tpu_torch.ops.kernels import partition
    from locust_tpu_torch.parallel import shuffle

    checked, seen = [], set()
    real, plain = shuffle.stable_partition, partition._plain

    def checking(bucket, valid, lanes, values, n_bins, cap, lcap=0, payload=None):
        out = real(bucket, valid, lanes, values, n_bins, cap, lcap, payload)
        shape = (*lanes.shape, int(n_bins), int(cap), int(lcap),
                 None if payload is None else int(payload.shape[1]))
        if lanes.device.type != "cuda" or shape in seen:
            return out
        seen.add(shape)
        want_rows, want_ovf, want_binned, want_totals = plain(
            *(t.cpu() for t in (bucket, valid, lanes, values)), *shape[2:5],
            None if payload is None else payload.cpu())
        rows, overflow, binned, totals = out
        ok = (_same_tensor(rows, want_rows) and int(overflow) == int(want_ovf)
              and _same_tensor(totals, want_totals))
        if payload is not None:
            filled = want_rows[:shape[2] * shape[3], -1].reshape(shape[2], shape[3]) != 0
            ok = ok and _same_tensor(binned.cpu()[filled], want_binned[filled])
        if not ok:
            raise AssertionError(f"the partition kernel differs from its plain version at "
                                 f"{shape} (rows, lanes, bins, cap, leftover, payload words)")
        checked.append(list(shape))
        return out

    shuffle.stable_partition = checking
    _PARTITION_CHECKED = checked
    return checked


def _same_tensor(a, b) -> bool:
    """``a`` (any device) equals ``b`` (CPU), shape, dtype and every element."""
    import torch

    return a.dtype == b.dtype and bool(torch.equal(a.cpu(), b))


def _append_launch_line(log_path: str, fields: dict) -> None:
    # One ``write`` to a file opened for appending, so the lines of
    # concurrent processes do not interleave.
    with open(log_path, "a", encoding="utf-8") as f:
        f.write(json.dumps(fields) + "\n")


def _log_worker_commands(log_path: str, module: str, args: list[str], worker_cls) -> None:
    """Make each command a worker handles append the kernel launches it
    made (its delta since the last line) to LOG, so a worker killed -9
    leaves the counts of every command it finished."""
    import threading

    lock = threading.Lock()
    last = dict.fromkeys(KERNELS, 0)
    handle = worker_cls._handle

    def counted_handle(self, req, files=None):
        try:
            return handle(self, req, files)
        finally:
            with lock:
                now = _launch_counts()
                delta = {k: now[k] - last[k] for k in last}
                if any(delta.values()):
                    last.update({k: now[k] for k in last})
                    _append_launch_line(log_path, {
                        "module": module, "argv": args, "pid": os.getpid(),
                        "cmd": req.get("cmd"), **delta,
                        "max_memory_reserved": now.get("max_memory_reserved")})

    worker_cls._handle = counted_handle


def _counted_child(log_path: str, module: str, args: list[str]) -> int:
    """``chip_smoke.py --counted-child LOG MODULE ARGS...``: a process of
    the distributor, serve-pool, failover or mesh phases.  Runs
    ``MODULE.main(ARGS)`` (``MODULE:FUNCTION`` runs ``FUNCTION(ARGS)``),
    then appends one JSON line to LOG: MODULE, ARGS
    and each kernel wrapper's launch count in this process.  A worker runs
    each of its maps as such a child of ``locust_tpu_torch.cli``, and
    appends a line for each command it handles that launched a kernel (a
    ``--serve`` worker's folds), none for the others."""
    import importlib

    if os.environ.get(COUNT_PLAIN_ENV):
        _count_plain_versions()
    name, _, entry = module.partition(":")  # MODULE or MODULE:FUNCTION
    mod = importlib.import_module(name)
    if module == "locust_tpu_torch.distributor.worker":
        mod.MAP_COMMAND = tuple(_counted(log_path, "locust_tpu_torch.cli"))
        _log_worker_commands(log_path, module, args, mod.Worker)
        return mod.main(args)
    extra = {}
    if "--mesh" in args or "--slices" in args or entry == "sort_world":
        extra["partition_checked"] = _check_partition_calls()
    with contextlib.ExitStack() as stack:
        if "--mesh" in args or "--slices" in args:
            extra["mesh"] = stack.enter_context(_mesh_recorder())
        try:
            return getattr(mod, entry or "main")(args)
        finally:
            if "mesh" in extra:
                from locust_tpu_torch.parallel.mesh import COMM

                extra["comm"] = COMM
            _append_launch_line(log_path, {"module": module, "argv": args,
                                           "pid": os.getpid(), **_launch_counts(), **extra})


@contextlib.contextmanager
def _mesh_recorder():
    """Record every mesh result built while it is open: its kernel mode,
    demotion, flagged re-folds, drain rounds, and the rank, world size and
    backend of its mesh; and each round of ``index --mesh``: its drain
    rounds (the round's stats, read on the host).  Yields the list the
    records go to."""
    from locust_tpu_torch.apps.inverted_index import DistributedInvertedIndex
    from locust_tpu_torch.parallel import shuffle

    records, real = [], shuffle.DistributedResult.__init__
    real_step = DistributedInvertedIndex._step

    def index_step(self, *a, **k):
        acc, leftover, stats = real_step(self, *a, **k)
        records.append({"index_drain_rounds": int(stats[4]), "rank": self.mesh.rank})
        return acc, leftover, stats

    def init(self, *a, **k):
        real(self, *a, **k)
        m = self.mesh
        records.append({"fused_kernel": self.fused_kernel, "fused_demoted": self.fused_demoted,
                        "fused_refolds": self.fused_refolds, "drain_rounds": self.drain_rounds,
                        "rank": m.rank, "size": m.size, "backend": m.backend,
                        "axes": dict(m.shape), "device": str(m.device)})

    shuffle.DistributedResult.__init__ = init
    DistributedInvertedIndex._step = index_step
    try:
        yield records
    finally:
        shuffle.DistributedResult.__init__ = real
        DistributedInvertedIndex._step = real_step


def _start_worker(env, name: str, plan: dict | None = None):
    """One port worker (``locust_tpu_torch.distributor.worker --port 0``,
    its maps under the counting wrapper), its stderr in a file; returns
    ``(proc, (host, port))`` once it listens."""
    cmd = [*_counted(env.launch_log, "locust_tpu_torch.distributor.worker"), "--port", "0",
           "--workdir", env.dist_tmp]
    if plan is not None:
        cmd += ["--fault-plan", json.dumps(plan)]
    err_path = os.path.join(env.work, f"{name}.stderr")
    with open(err_path, "wb") as err:
        proc = subprocess.Popen(cmd, cwd=HERE, env=env.dist_env, stdout=subprocess.DEVNULL,
                                stderr=err)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        with open(err_path, "rb") as f:
            m = re.search(rb"listening on ([\d.]+):(\d+)", f.read())
        if m:
            return proc, (m.group(1).decode(), int(m.group(2)))
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    with open(err_path, "rb") as f:
        raise AssertionError(f"worker {name} did not start: {f.read()[-2000:]!r}")


def _stop_workers(workers, secret: str = DIST_SECRET) -> None:
    """Shut each worker down over the wire, then make sure it exited."""
    from locust_tpu_torch.distributor import master

    for proc, addr in workers:
        try:
            master.rpc(addr, {"cmd": "shutdown"}, secret.encode(), timeout=10)
        except (OSError, ValueError, PermissionError):
            pass
    for proc, _ in workers:
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)


def _launch_lines(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _spans_s(doc: dict, name: str) -> list[tuple[dict, float]]:
    return [(e.get("args", {}), e["dur"] / 1e6) for e in doc["traceEvents"]
            if e.get("name") == name and e.get("ph") == "X"]


def distributor_phase(env) -> dict:
    """The distributed tier on the card: 2 port workers as processes
    sharing it, the port's master as a process over a cluster file, each
    job's stdout byte-identical to the one-shot CLI and the oracle; a
    chaos job; the merged trace; the breaker; the loopback data-plane
    microbench.  Every process of a job that launches kernels runs under
    ``_counted_child`` and appends its launches to one log, emptied just
    before the job and read just after it."""
    from locust_tpu_torch.backend import CircuitBreaker
    from locust_tpu_torch.distributor.microbench import run_microbench
    from locust_tpu_torch.engine import MapReduceEngine
    from locust_tpu_torch.utils import faultplan

    torch = env.torch
    on_card = env.dev.type == "cuda"
    report = {"card": env.smi, "jobs": {}}
    env.dist_tmp = os.path.join(env.work, "dist_tmp")
    os.makedirs(env.dist_tmp, exist_ok=True)
    launch_log = env.launch_log = os.path.join(env.work, "launches.jsonl")
    env.dist_env = dict(os.environ, LOCUST_SECRET=DIST_SECRET, TMPDIR=env.dist_tmp,
                        PYTHONPATH=os.pathsep.join(
                            p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    n_lines = len(env.lines)
    per = -(-n_lines // 2)
    shard_blocks = [-(-per // env.BL), -(-(n_lines - per) // env.BL)]

    def map_expect(mode: str, shard: int) -> dict:
        nb = shard_blocks[shard]
        if mode == "fused":
            return {"tokenize": 0, "bitonic_sort": 0, "fused_fold": nb}
        return {"tokenize": nb, "bitonic_sort": 2 * nb, "fused_fold": 0}

    reduce_expect = {"bitonic": {"tokenize": 0, "bitonic_sort": 1, "fused_fold": 0},
                     "fused": {"tokenize": 0, "bitonic_sort": 0, "fused_fold": 0}}

    def run_master(name: str, cluster_file: str, mode: str, extra: list[str]) -> dict:
        trace = os.path.join(env.work, f"{name}.trace.json")
        cmd = [*_counted(launch_log, "locust_tpu_torch.distributor.master"), cluster_file,
               env.corpus_file, "--workdir", os.path.join(env.work, name),
               "--trace-out", trace, *extra, *env.cli_extra]
        open(launch_log, "w").close()  # every count to 0 just before the job
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, env=env.dist_env, capture_output=True,
                              timeout=900)
        wall = time.perf_counter() - t0
        lines = _launch_lines(launch_log)  # and read just after it
        err = proc.stderr.decode(errors="replace")
        if proc.returncode != 0:
            raise AssertionError(f"master {name} exited {proc.returncode}: {err[-3000:]}")
        if proc.stdout != env.want or proc.stdout != env.oneshot_out:
            raise AssertionError(f"master {name}: stdout differs from the one-shot CLI / oracle")
        with open(trace, encoding="utf-8") as f:
            doc = json.load(f)
        dp = re.search(r"dataplane: (\d+)B payload / (\d+)B wire in (\d+) chunk\(s\), "
                       r"binary=(\w+) zlib=(\w+) fetch=([\d.]+|None) MB/s", err)
        shards = {int(m[0]): {"elapsed_s": float(m[1]), "winner": int(m[2]),
                              "attempts": int(m[3])}
                  for m in re.findall(r"shard (\d+): ([\d.]+)s on worker (\d+), (\d+) attempt",
                                      err)}
        for args, dur in _spans_s(doc, "master.map_rpc"):
            shards[args["shard"]].setdefault("map_rpc_s", []).append(dur)
        for args, dur in _spans_s(doc, "worker.map"):
            shards[args["shard"]].setdefault("worker_map_s", []).append(dur)
        for args, dur in _spans_s(doc, "master.fetch"):
            shard = int(re.search(r"shard(\d+)_a", args["path"]).group(1))
            shards[shard].setdefault("fetch_s", []).append(dur)
        maps = [ln for ln in lines if ln["module"] == "locust_tpu_torch.cli"
                and ln["argv"][4:5] == ["1"]]
        reduces = [ln for ln in lines if ln["module"] == "locust_tpu_torch.distributor.master"]
        kernels = ("tokenize", "bitonic_sort", "fused_fold")
        for ln in maps:
            shards[int(ln["argv"][3])].setdefault("launches", []).append(
                {k: ln[k] for k in kernels})
        job = {
            "mode": mode, "argv": extra, "wall_s": wall,
            "job_run_s": sum(d for _, d in _spans_s(doc, "job.run")),
            "reduce_s": sum(d for n in ("cli.load", "cli.run", "cli.output")
                            for _, d in _spans_s(doc, n)),
            "shards": shards,
            "dataplane": None if dp is None else {
                "payload_bytes": int(dp[1]), "wire_bytes": int(dp[2]), "chunks": int(dp[3]),
                "binary": dp[4] == "True", "zlib": dp[5] == "True",
                "fetch_mb_s": None if dp[6] == "None" else float(dp[6])},
            "reduce_launches": {k: sum(ln[k] for ln in reduces) for k in kernels},
            "trace": doc,
        }
        if (len(reduces) != 1 or len(maps) + len(reduces) != len(lines)
                or sorted({int(ln["argv"][3]) for ln in maps}) != [0, 1]):
            raise AssertionError(f"master {name}: launch log has {len(maps)} map and "
                                 f"{len(reduces)} reduce lines")
        env.by_path[name] = {k: sum(ln[k] for ln in lines) for k in kernels}
        if on_card:
            for ln in maps:
                if {k: ln[k] for k in kernels} != map_expect(mode, int(ln["argv"][3])):
                    raise AssertionError(f"master {name}: shard {ln['argv'][3]}'s map launched "
                                         f"{ln}, expected {map_expect(mode, int(ln['argv'][3]))}")
            if job["reduce_launches"] != reduce_expect[mode]:
                raise AssertionError(f"master {name}: the reduce launched "
                                     f"{job['reduce_launches']}")
            env.expected[name] = {k: sum(map_expect(mode, int(ln["argv"][3]))[k]
                                         for ln in maps) + reduce_expect[mode][k]
                                  for k in kernels}
            env.check_counts(name)
        log(f"  {name} ({' '.join(extra) or 'defaults'}): stdout == one-shot CLI == oracle; "
            f"master process wall {wall:.3f} s, job.run {job['job_run_s']:.3f} s, reduce "
            f"{job['reduce_s']:.3f} s; dataplane {json.dumps(job['dataplane'])}")
        for shard, st in sorted(shards.items()):
            log(f"    shard {shard}: {st['attempts']} attempt(s), won by worker {st['winner']} "
                f"in {st['elapsed_s']:.3f} s; map RPC s {[round(x, 3) for x in st['map_rpc_s']]}"
                f", worker.map s {[round(x, 3) for x in st.get('worker_map_s', [])]}, fetch s "
                f"{[round(x, 4) for x in st.get('fetch_s', [])]}, map launches "
                f"{st.get('launches')}")
        return job

    work_dist = os.path.join(env.work, "dist")
    os.makedirs(work_dist, exist_ok=True)
    with phase("the distributor: 2 port workers (processes) share the card; the port's master "
               "under bitonic (bin, tsv) and fused, each byte-identical to the one-shot CLI"):
        log(f"  card: {env.smi}")
        # Where a process's time goes before its work: the interpreter,
        # torch's import, a CUDA context, the port's modules.
        starts = {}
        probes = [("python", "pass"), ("import torch", "import torch"),
                  ("import the port's CLI and master",
                   "import locust_tpu_torch.cli, locust_tpu_torch.distributor.master")]
        if on_card:
            probes.insert(2, ("import torch + a CUDA context", "import torch; torch.zeros(1, "
                              "device='cuda'); torch.cuda.synchronize()"))
        for what, code in probes:
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env.dist_env,
                           check=True, timeout=300)
            starts[what] = time.perf_counter() - t0
        report["process_start_s"] = starts
        log(f"  process start, wall s: {json.dumps(starts)}")
        t0 = time.perf_counter()
        one = subprocess.run([sys.executable, "-m", "locust_tpu_torch", env.corpus_file,
                              "--trace", *env.cli_extra], cwd=HERE, env=env.dist_env,
                             capture_output=True, timeout=900)
        report["oneshot_cli_wall_s"] = time.perf_counter() - t0
        if one.returncode != 0 or one.stdout != env.want:
            raise AssertionError(f"the one-shot CLI process: rc {one.returncode}, stdout == "
                                 f"oracle {one.stdout == env.want}")
        env.oneshot_out = one.stdout
        report["oneshot_cli_spans_ms"] = {
            k: float(v) for k, v in re.findall(r"^(load|run|output)\s+([\d.]+) ms",
                                               one.stderr.decode(errors="replace"), re.M)}
        log(f"  one-shot CLI process (python -m locust_tpu_torch FILE --trace): "
            f"{report['oneshot_cli_wall_s']:.3f} s wall, its spans ms "
            f"{json.dumps(report['oneshot_cli_spans_ms'])}, stdout == oracle")
        workers = []
        try:
            workers = [_start_worker(env, f"worker{i}") for i in range(2)]
            cluster = os.path.join(work_dist, "cluster.txt")
            with open(cluster, "w") as f:
                f.write("".join(f"{h} {p}\n" for _, (h, p) in workers))
            log(f"  workers listening on {[a for _, a in workers]}")
            for name, mode, extra in (("dist_bitonic_bin", "bitonic", []),
                                      ("dist_bitonic_tsv", "bitonic", ["--inter-format", "tsv"]),
                                      ("dist_fused", "fused", ["--sort-mode", "fused",
                                                               "--no-timing"])):
                report["jobs"][name] = run_master(name, cluster, mode, extra)
            doc = report["jobs"]["dist_bitonic_bin"].pop("trace")
            names = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
            pids = {names[e["pid"]] for e in doc["traceEvents"] if e.get("name") == "worker.map"}
            want_pids = {f"worker {h}:{p}" for _, (h, p) in workers}
            if pids != want_pids or not isinstance(doc["otherData"].get("trace_id"), str):
                raise AssertionError(f"the merged trace's worker.map spans come from {pids}, "
                                     f"expected {want_pids}")
            log(f"  --trace-out: one trace id {doc['otherData']['trace_id']}, worker.map spans "
                f"from {sorted(pids)}, {len(doc['traceEvents'])} records")
        finally:
            _stop_workers(workers)
        for job in report["jobs"].values():
            job.pop("trace", None)

    with phase("the distributor under chaos: worker.map crash x1 on one worker, io.chunk "
               "corrupt x1 on the other; byte-identical"):
        workers = []
        try:
            workers = [
                _start_worker(env, "chaos0", {"rules": [
                    {"site": "worker.map", "action": "crash", "times": 1}]}),
                _start_worker(env, "chaos1", {"rules": [
                    {"site": "io.chunk", "action": "corrupt", "times": 1}]})]
            cluster = os.path.join(work_dist, "chaos_cluster.txt")
            with open(cluster, "w") as f:
                f.write("".join(f"{h} {p}\n" for _, (h, p) in workers))
            job = run_master("dist_chaos", cluster, "bitonic", [])
            job.pop("trace")
            extra = sum(st["attempts"] for st in job["shards"].values()) - 2
            if extra < 2:
                raise AssertionError(f"the chaos job took {extra} extra attempts, expected >= 2")
            job["extra_attempts"] = extra
            report["jobs"]["dist_chaos"] = job
            log(f"  chaos job: {extra} extra attempts, stdout == one-shot CLI == oracle")
        finally:
            _stop_workers(workers)

    with phase("the backend breaker: run_checkpointed(every=2, breaker=CircuitBreaker(2, "
               "0.05)) under a backend.dispatch error plan (times 3), then with no plan"):
        from locust_tpu_torch import obs

        eng = MapReduceEngine(env.cfg, device=env.dev)
        breaker = {}
        for name, rules in (("breaker_faults", [{"site": "backend.dispatch", "action": "error",
                                                 "times": 3}]),
                            ("breaker_clean", None)):
            br = CircuitBreaker(threshold=2, cooldown_s=0.05)
            ck = os.path.join(env.work, name)
            obs.enable(process=name)
            try:
                with (faultplan.active_plan(faultplan.FaultPlan(rules, seed=7)) if rules
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    res, env.by_path[name] = env.counted(
                        lambda: eng.run_checkpointed(env.rows, ck, every=2, breaker=br))
                    wall = time.perf_counter() - t0
                doc = obs.export(os.path.join(env.work, f"{name}.trace.json"))
            finally:
                obs.disable()
            env.check_pairs(name, res, env.oracle)
            events = [e["name"] for e in doc["traceEvents"] if e["name"].startswith("backend.")]
            st = br.stats()
            breaker[name] = {"wall_s": wall, "stats": st, "events": events,
                             "launches": env.by_path[name]}
            # Every fold on the card: each block folded once there (a
            # failed dispatch launches nothing), no backend.failover, and
            # the table the run returns lives on the card.
            env.expected[name] = {"tokenize": env.nblocks, "bitonic_sort": env.nblocks,
                                  "fused_fold": 0}
            if ("backend.failover" in events or st["successes"] != env.nblocks
                    or res.table.key_lanes.device.type != env.dev.type or st["state"] != "closed"):
                raise AssertionError(f"{name}: breaker {st}, events {events}, table on "
                                     f"{res.table.key_lanes.device}")
            if on_card:
                env.check_counts(name)
            if rules:
                if st["trips"] != 1 or st["failures"] != 3:
                    raise AssertionError(f"{name}: breaker {st}")
            elif st["failures"] or events:
                raise AssertionError(f"{name}: breaker {st}, events {events}")
            log(f"  {name}: pairs == oracle in {wall:.3f} s, every fold on {env.dev}; breaker "
                f"{json.dumps(st)}; backend.* events {events}; launches {env.by_path[name]}")
        report["breaker"] = breaker

    with phase("the loopback data-plane microbench (json_w1, bin_w1, bin_wK, bin_wK_z)"):
        bench = run_microbench()
        for name, st in bench["variants"].items():
            log(f"  {name}: {st['mb_s']} MB/s, {st['bytes']} B payload, {st['wire_bytes']} B "
                f"wire, {st['chunks']} chunks, window {st['window']}")
        log(f"  summary {json.dumps(bench['summary'])} (host sockets on the card's machine; "
            f"card: {env.smi})")
        report["microbench"] = bench
    return report


SERVE_SECRET = "chip-smoke-serve"


def _table(pairs) -> bytes:
    """A WordCount result as the CLI prints it: ``key\\tcount`` lines in key order."""
    return b"".join(k + b"\t" + str(v).encode() + b"\n" for k, v in sorted(pairs))


def _start_daemon(env, name: str, args: list[str], counted_log: str | None = None):
    """``python -m locust_tpu_torch.serve --port 0 ARGS`` as a process (under
    the counting wrapper, appending to ``counted_log``, when one is given),
    its stderr in a file; returns ``(proc, port, seconds to listening)``."""
    err_path = os.path.join(env.work, f"{name}.stderr")
    cmd = ([sys.executable, "-m", "locust_tpu_torch.serve"] if counted_log is None
           else _counted(counted_log, "locust_tpu_torch.serve.__main__"))
    t0 = time.perf_counter()
    with open(err_path, "wb") as err:
        proc = subprocess.Popen(
            [*cmd, "--port", "0", *env.serve_daemon_extra, *args],
            cwd=HERE, env=env.serve_env, stdout=subprocess.DEVNULL, stderr=err)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        with open(err_path, "rb") as f:
            m = re.search(rb"listening on [\d.]+:(\d+)", f.read())
        if m:
            return proc, int(m.group(1)), time.perf_counter() - t0
        if proc.poll() is not None:
            break
        time.sleep(0.02)
    proc.kill()
    proc.wait(timeout=30)
    with open(err_path, "rb") as f:
        raise AssertionError(f"serve daemon {name} did not start: {f.read()[-2000:]!r}")


def _serve_cli(env, port: int, args: list[str], check: bool = True):
    """One ``python -m locust_tpu_torch.serve`` client command against the
    daemon on ``port``; returns the completed process."""
    out = subprocess.run(
        [sys.executable, "-m", "locust_tpu_torch.serve", *args, "--port", str(port)],
        cwd=HERE, env=env.serve_env, capture_output=True, timeout=600)
    if check and out.returncode != 0:
        raise AssertionError(f"serve {args[:1]} exited {out.returncode}: "
                             f"{out.stderr.decode(errors='replace')[-2000:]}")
    return out


def _stop_daemon(env, proc, port: int) -> None:
    """``shutdown`` over the wire, then make sure the process exited."""
    if proc.poll() is None:
        _serve_cli(env, port, ["shutdown"], check=False)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def serve_phase(env) -> dict:
    """The serve daemon on the card (``locust_tpu_torch.serve``).

    1. In process, at the CLI's widths (``env.serve_cfg`` adds nothing on
       the card): a stream of one-block jobs over 3 tenants, half under
       ``bitonic`` (kernel B) and half under ``fused`` (kernel C), in two
       waves whose batches the scheduler coalesces (it is paused while a
       wave is submitted); 2 jobs at the inline cap ``max_corpus_bytes``;
       the one-block jobs again (result-cache hits); 4 new one-block jobs
       (warm executable hits); per mode two jobs alone, a cold and a warm
       one (a job's latency without batch mates); a default-config job
       (``hash``, no kernel); a ``tfidf`` plan job under ``bitonic`` and
       its repeat.
       Every output equals the port's one-shot CLI and the oracle; the
       cache answers and counters, and each kernel's launches in the
       stream (padded jobs and blocks included), equal the prediction.
    2. The daemon as a process with ``--journal-dir`` and ``--warm-dir``:
       a 16 MiB job submitted with ``--no-wait``, the daemon killed -9
       while it dispatches, restarted on the same directories, and
       ``result JOB --wait`` byte for byte the one-shot CLI's; then
       ``shutdown``, a restart under a ``serve.dispatch`` error plan and
       the job again: ``cache=result`` (answered at admission).  Then
       chaos on that daemon: ``--max-attempts 2`` answers
       ``[poison_job]`` and ``--deadline 0.7`` ``[deadline_exceeded]``,
       exit 1 each, and the daemon stays up."""
    from locust_tpu_torch import obs
    from locust_tpu_torch.plan import tfidf_plan
    from locust_tpu_torch.serve import ServeClient, ServeConfig, ServeDaemon
    from locust_tpu_torch.serve.cache import bucket_blocks

    on_card = env.dev.type == "cuda"
    report = {"card": env.smi}
    BL, W, E, K = env.BL, env.W, env.E, env.K
    work = os.path.join(env.work, "serve")
    os.makedirs(work, exist_ok=True)
    env.serve_env = dict(os.environ, LOCUST_SECRET=SERVE_SECRET, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    rng = np.random.default_rng(9)

    def one_block(i: int) -> bytes:
        """Block i of the corpus with a seeded last line: distinct bytes."""
        words = b" ".join(b"serve%06d" % w for w in rng.integers(0, 10**6, 4))
        return b"\n".join(env.lines[i * BL:(i + 1) * BL - 1] + [words]) + b"\n"

    def up_to(nbytes: int, start: int) -> bytes:
        out, total = [], 0
        for ln in env.lines[start:]:
            if total + len(ln) + 1 > nbytes:
                break
            out.append(ln)
            total += len(ln) + 1
        return b"\n".join(out) + b"\n"

    def oneshot(name: str, corpus: bytes, argv=()) -> bytes:
        path = os.path.join(work, f"{name}.txt")
        with open(path, "wb") as f:
            f.write(corpus)
        return env.run_cli(f"serve_oneshot_{name}", [*argv, path, *env.cli_extra])

    modes = ("bitonic", "fused")
    wave_a = [(one_block(i), modes[i % 2], f"t{i % 3}") for i in range(8)]
    wave_b = [(one_block(8 + i), modes[i % 2], f"t{(8 + i) % 3}") for i in range(4)]
    fresh = [(one_block(12 + i), modes[i % 2], f"t{i % 3}") for i in range(4)]
    solo = [(one_block(17 + i), modes[i // 2], "t0") for i in range(4)]
    cap = env.serve_big_bytes
    big = [(up_to(cap, 0), "bitonic", "t0"), (up_to(cap, 1), "fused", "t1")]
    default_job = one_block(16)
    plan_corpus = b"\n".join(env.lines[:8 * BL]) + b"\n"
    plan_doc = tfidf_plan(BL).to_doc()
    big_bucket = [bucket_blocks(-(-len(c.splitlines()) // BL)) for c, _, _ in big]

    # The prediction: a batch of n one-block jobs folds bucket_blocks(n)
    # blocks (padded job slots fold zero blocks); a big job folds its
    # bucket; a solo job 1 block; the plan job one sort per block of its
    # 8; "hash" nothing.
    want_launches = {
        "tokenize": 0, "pagerank": 0, "partition": 0,
        "bitonic_sort": bucket_blocks(4) + bucket_blocks(2) + big_bucket[0]
        + bucket_blocks(2) + 2 + 8,
        "fused_fold": bucket_blocks(4) + bucket_blocks(2) + big_bucket[1] + bucket_blocks(2)
        + 2,
    }
    want_exec = {"engines": 4, "shapes": 10, "hits": 4, "misses": 10, "builds": 4,
                 "compiles": 10, "evictions": 0, "fused_on": 1, "fused_demoted": 0}
    want_results = {"entries": 24, "hits": 13, "misses": 24, "invalidations": 0}

    with phase("the serve daemon in process: one-block bitonic/fused jobs over 3 tenants, 2 "
               f"jobs at the {cap} B inline cap, repeats, new corpora, hash, a tfidf plan"):
        log(f"  card: {env.smi}")
        traced = obs.current() is None
        if traced:
            obs.enable(process="serve")
        first_event = obs.current().event_count()
        d = ServeDaemon(secret=SERVE_SECRET.encode(), cfg=ServeConfig(
            max_batch=8, warm_dir=os.path.join(work, "warm_inproc"), dispatch_poll_s=0.005),
            device=env.dev)
        d.serve_in_thread()
        client = ServeClient(d.addr, SERVE_SECRET.encode(), timeout=600.0)
        answers = []  # (label, corpus, config, reply, status)

        def submit(items, label, paused=True, **kw):
            if paused:
                d.scheduler.pause()
            acks = [(c, m, client.submit(corpus=c, tenant=t, weight=kw.get("weight", 1.0),
                                         config=dict(env.serve_cfg, sort_mode=m)))
                    for c, m, t in items]
            d.scheduler.resume()
            for c, m, ack in acks:
                res = client.wait(ack["job_id"], timeout=600.0, poll_s=0.005)
                answers.append((label, c, m, res, client.status(ack["job_id"])))

        def stream():
            t0 = time.perf_counter()
            submit(wave_a, "cold")
            submit(wave_b, "cold")
            for item in big:
                submit([item], "big", weight=2.0)
            submit(wave_a + wave_b, "repeat")
            submit(fresh, "warm")
            for (c, m, t), label in zip(solo, ("solo_cold", "solo_warm") * 2):
                submit([(c, m, t)], label, paused=False)
            ack = client.submit(corpus=default_job)
            answers.append(("hash", default_job, "hash", client.wait(ack["job_id"], timeout=600.0),
                            client.status(ack["job_id"])))
            for label in ("plan", "plan_repeat"):
                ack = client.submit(corpus=plan_corpus, plan=plan_doc,
                                    config=dict(env.serve_cfg, sort_mode="bitonic"))
                answers.append((label, plan_corpus, "bitonic",
                                client.wait(ack["job_id"], timeout=600.0),
                                client.status(ack["job_id"])))
            return time.perf_counter() - t0

        try:
            wall, env.by_path["serve"] = env.counted(stream)
            stats = client.stats()
            engines = list(d.executables._engines.values())
        finally:
            d.close()
        spans = collections.defaultdict(float)
        span_n = collections.Counter()
        dispatches = []  # (jobs, bucket, ms) of each serve.dispatch span
        for e in obs.current().to_chrome()["traceEvents"][first_event:]:
            if e.get("ph") == "X" and e["name"].startswith("serve."):
                spans[e["name"]] += e["dur"] / 1e3
                span_n[e["name"]] += 1
                if e["name"] == "serve.dispatch":
                    dispatches.append((e["args"]["jobs"], e["args"]["bucket"], e["dur"] / 1e3))
        if traced:
            obs.disable()
        # Every answer against the oracle and the one-shot CLI.
        checked = {}
        for label, corpus, mode, res, st in answers:
            if res.get("plan"):
                tf, n_docs = oracle_docs(corpus.splitlines(), BL, W, E, K)
                want = render_tfidf(tf, n_docs)
                got = res["pairs"][0][0]
                key = ("plan", corpus)
                if key not in checked:
                    checked[key] = oneshot("tfidf", corpus, ["tfidf", "--lines-per-doc", str(BL),
                                                              "--sort-mode", "bitonic"])
            else:
                want = _table(oracle_wordcount(corpus.splitlines(), W, E, K).items())
                got = _table(res["pairs"])
                key = ("wc", corpus)
                if key not in checked:
                    checked[key] = oneshot(f"wc{len(checked)}", corpus)
            if got != want or got != checked[key] or res["truncated"]:
                raise AssertionError(f"serve job ({label}, {mode}): output differs from the "
                                     f"oracle ({got == want}) or the one-shot CLI "
                                     f"({got == checked[key]})")
        labels = collections.Counter((label, res["cache"]) for label, _, _, res, _ in answers)
        want_labels = collections.Counter({("cold", "cold"): 12, ("big", "cold"): 2,
                                           ("repeat", "result"): 12, ("warm", "warm"): 4,
                                           ("solo_cold", "cold"): 2, ("solo_warm", "warm"): 2,
                                           ("hash", "cold"): 1, ("plan", "cold"): 1,
                                           ("plan_repeat", "result"): 1})
        exec_c = stats["exec_cache"]
        res_c = {k: stats["result_cache"][k] for k in want_results}
        launches = env.by_path["serve"]
        report["launches"], report["expected_launches"] = launches, want_launches
        report["exec_cache"], report["result_cache"] = exec_c, stats["result_cache"]
        log(f"  {len(answers)} answers == oracle == one-shot CLI ({len(checked)} CLI runs); "
            f"cache answers {dict(labels)}")
        log(f"  exec_cache {json.dumps(exec_c)}; result_cache {json.dumps(stats['result_cache'])}")
        log(f"  launches in the stream: {launches}, expected {want_launches}")
        if labels != want_labels:
            raise AssertionError(f"serve cache answers {dict(labels)} != {dict(want_labels)}")
        if exec_c != want_exec or res_c != want_results:
            raise AssertionError(f"serve cache counters: exec {exec_c} (want {want_exec}), "
                                 f"results {res_c} (want {want_results})")
        if on_card and launches != want_launches:
            raise AssertionError(f"serve launches {launches} != {want_launches}")
        # Every engine on the daemon's device; no job retried or failed.
        devices = {str(getattr(e, "device", None)) for e in engines}
        if devices != {str(env.dev)} or stats["jobs_by_state"] != {"done": len(answers)} \
                or any(st["attempts"] for *_, st in answers):
            raise AssertionError(f"serve engines on {devices}, jobs {stats['jobs_by_state']}, "
                                 f"attempts {[st['attempts'] for *_, st in answers]}")
        lat = [float(res["latency_ms"]) for *_, res, _ in answers]
        by_label = collections.defaultdict(list)
        for label, _, _, res, st in answers:
            by_label[label].append(float(res["latency_ms"]))
        batches = [st["batch_size"] for *_, st in answers if st["batch_size"]]
        report["stream"] = {
            "jobs": len(answers), "wall_s": wall, "qps": len(answers) / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "mean_batch": sum(batches) / len(batches),
            "latency_ms_by_kind": {k: {"min": min(v), "median": float(np.median(v)),
                                       "max": max(v)} for k, v in by_label.items()},
            "serve_span_ms": dict(spans), "serve_span_count": dict(span_n),
            "dispatch_ms": [{"jobs": j, "bucket": b, "ms": ms} for j, b, ms in dispatches],
        }
        log(f"  stream: {json.dumps(report['stream'])}")

    with phase("the serve daemon as a process: --journal-dir, --warm-dir; a 16 MiB job, "
               "kill -9 during its dispatch, restart, result --wait; shutdown, restart under "
               "a serve.dispatch error plan, repeat; --max-attempts 2 -> poison_job, "
               "--deadline 0.7 -> deadline_exceeded"):
        jdir, wdir = os.path.join(work, "journal"), os.path.join(work, "warm")
        big_file = os.path.join(work, "big.txt")
        with open(big_file, "wb") as f:
            f.write(big[0][0])
        want_out = checked[("wc", big[0][0])]
        dirs = ["--journal-dir", jdir, "--warm-dir", wdir]
        job_cfg = ["--sort-mode", "bitonic", *env.serve_submit_extra]
        proc, port, start_s = _start_daemon(env, "serve_daemon", dirs)
        try:
            t0 = time.perf_counter()
            sub = _serve_cli(env, port, ["submit", big_file, "--no-wait", *job_cfg])
            submit_s = time.perf_counter() - t0
            job_id = sub.stdout.decode().strip()
            client = ServeClient(("127.0.0.1", port), SERVE_SECRET.encode(), timeout=60.0)
            state, polls = "queued", 0
            while state == "queued":
                state = client.status(job_id)["state"]
                polls += 1
            proc.kill()  # SIGKILL
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        log(f"  daemon up in {start_s:.3f} s; submit --no-wait {submit_s:.3f} s (a client "
            f"process: no torch); killed -9 with the job {state} after {polls} status polls")
        if state != "running":
            raise AssertionError(f"the job was {state} when the daemon was killed, not running")
        # The replay alone: a daemon in this process on a copy of the
        # journal, its construction timed against one with no journal.
        shutil.copytree(jdir, jdir + "_copy")
        times = {}
        for name, kw in (("no_journal", {}), ("journal", {"journal_dir": jdir + "_copy"})):
            t0 = time.perf_counter()
            d = ServeDaemon(secret=SERVE_SECRET.encode(), cfg=ServeConfig(**kw), device=env.dev)
            times[name] = time.perf_counter() - t0
            d.close()
        replay_s = times["journal"] - times["no_journal"]
        log(f"  replay alone (in process, a copy of the journal): {replay_s:.4f} s "
            f"({json.dumps(times)})")
        proc, port, restart_s = _start_daemon(env, "serve_daemon_replay", dirs)
        try:
            t0 = time.perf_counter()
            res = _serve_cli(env, port, ["result", job_id, "--wait", "--timeout", "600"])
            result_s = time.perf_counter() - t0
            if res.stdout != want_out:
                raise AssertionError("the replayed job's output differs from the one-shot CLI")
            _serve_cli(env, port, ["shutdown"])
            proc.wait(timeout=120)
        finally:
            _stop_daemon(env, proc, port)
        log(f"  restart on the journal: listening after {restart_s:.3f} s (replay included), "
            f"result --wait {result_s:.3f} s later; stdout == one-shot CLI == oracle")
        # The third start also carries a serve.dispatch error plan: the
        # repeat is answered from the restored result cache at admission
        # (no dispatch); then the chaos jobs fail structured.
        plan = json.dumps({"rules": [{"site": "serve.dispatch", "action": "error"}]})
        small = os.path.join(work, "small.txt")
        with open(small, "wb") as f:
            f.write(wave_a[0][0])
        proc, port, warm_s = _start_daemon(env, "serve_daemon_warm",
                                           [*dirs, "--fault-plan", plan])
        try:
            again = _serve_cli(env, port, ["submit", big_file, *job_cfg])
            if again.stdout != want_out or b"cache=result" not in again.stderr:
                raise AssertionError(f"after a clean restart the job was not a result-cache hit: "
                                     f"{again.stderr.decode(errors='replace')[-500:]}")
            log(f"  shutdown, restart ({warm_s:.3f} s), submit again: cache=result, stdout == "
                "one-shot CLI")
            codes = {}
            for flag, code in ((["--max-attempts", "2"], "poison_job"),
                               (["--deadline", "0.7"], "deadline_exceeded")):
                out = _serve_cli(env, port, ["submit", small, *flag, *env.serve_submit_extra],
                                 check=False)
                err = out.stderr.decode(errors="replace")
                if out.returncode != 1 or f"error: [{code}]" not in err:
                    raise AssertionError(f"chaos {flag}: exit {out.returncode}, {err[-500:]}")
                codes[code] = out.returncode
            st = json.loads(_serve_cli(env, port, ["stats"]).stdout)
            if st["jobs_by_state"] != {"done": 1, "failed": 2}:
                raise AssertionError(f"chaos stats: {st['jobs_by_state']}")
        finally:
            _stop_daemon(env, proc, port)
        log(f"  under a serve.dispatch error plan: {codes} with exit 1 each; the daemon stayed "
            f"up and answered stats ({st['jobs_by_state']})")
        report["process"] = {"daemon_start_s": start_s, "submit_no_wait_s": submit_s,
                             "state_at_kill": state, "replay_s": replay_s,
                             "restart_to_listening_s": restart_s,
                             "restart_result_wait_s": result_s, "warm_restart_s": warm_s}
        report["chaos"] = codes
    return report


def _start_serve_worker(env, name: str, log_path: str, plan: dict | None = None):
    """One port ``--serve`` worker as a process under the counting wrapper
    (a line per command that launched a kernel), its stderr in a file;
    returns ``(proc, "host:port", seconds to listening)``."""
    cmd = [*_counted(log_path, "locust_tpu_torch.distributor.worker"), "--serve", "--port", "0",
           "--workdir", env.pool_tmp, *env.serve_daemon_extra]
    if plan is not None:
        cmd += ["--fault-plan", json.dumps(plan)]
    err_path = os.path.join(env.work, f"{name}.stderr")
    t0 = time.perf_counter()
    with open(err_path, "wb") as err:
        proc = subprocess.Popen(cmd, cwd=HERE, env=env.serve_env, stdout=subprocess.DEVNULL,
                                stderr=err)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        with open(err_path, "rb") as f:
            m = re.search(rb"listening on ([\d.]+):(\d+)", f.read())
        if m:
            return proc, f"{m.group(1).decode()}:{int(m.group(2))}", time.perf_counter() - t0
        if proc.poll() is not None:
            break
        time.sleep(0.02)
    proc.kill()
    proc.wait(timeout=30)
    with open(err_path, "rb") as f:
        raise AssertionError(f"serve worker {name} did not start: {f.read()[-2000:]!r}")


def web_graph_edges(max_bytes: int, seed: int = 20) -> tuple[bytes, int, np.ndarray, np.ndarray]:
    """The largest prefix of ``synthetic_web_graph``'s edge list whose
    ``src dst`` lines fit ``max_bytes``: (bytes, nodes it names, src, dst)."""
    _, src, dst = synthetic_web_graph(seed)
    lines = [f"{a} {b}\n".encode() for a, b in zip(src.tolist(), dst.tolist())]
    ends = np.cumsum([len(ln) for ln in lines])
    e = int(np.searchsorted(ends, max_bytes, side="right"))
    src, dst = src[:e], dst[:e]
    return b"".join(lines[:e]), int(max(src.max(), dst.max())) + 1, src, dst


def _rank_values(rendered: bytes) -> np.ndarray:
    return np.array([float(r.split(b"\t")[1]) for r in rendered.splitlines()])


def pool_phase(env) -> dict:
    """The serve tier's scale-out and high availability on the card.

    1. ``python -m locust_tpu_torch.serve --workers A,B --shard-min-blocks
       16`` over 2 ``python -m locust_tpu_torch.distributor.worker --serve``
       processes, all sharing the card, every process under the counting
       wrapper: one-block ``bitonic`` and ``fused`` jobs in turn through
       ``serve_batch`` (the second of each mode lands warm on the first
       worker by affinity), and a job at the inline cap sharded over both
       workers and merged on the daemon's card.
    2. Distributed plans over the same pool: ``tfidf`` and ``index`` under
       ``bitonic`` (kernel B in the tf fold of each map split), a join tree
       of two WordCount folds under ``fused`` (kernel C in each map split)
       and its repeat (the workers' fold-node engines warm, their
       ``compiles`` flat), and PageRank over the largest prefix of the
       seeded web graph whose edge list fits the inline cap.  The first
       three equal the port's one-shot CLI or solo engine byte for byte;
       PageRank's ranks are held to the solo engine and a float64 oracle
       within a stated tolerance (the card's ``index_add_`` adds in no
       fixed order).
    3. The first worker holds its next ``serve_batch`` 3 s (``rpc.delay``)
       and is killed -9 while it holds it; the job is retried on the
       survivor and answers exactly.  The kernel B and C launches summed
       over the daemon and the workers equal the prediction.
    4. Failover: a primary with ``--journal-dir --ship-to`` (its dispatch
       held by a ``serve.dispatch`` delay) and a standby with
       ``--journal-dir --standby-of --lease``; a job at the inline cap
       submitted with ``--no-wait``, the primary killed -9 while it is
       running, the standby promoted by its lease, the job answered under
       its original id byte for byte as the one-shot CLI, and a ship of
       the old epoch refused with ``stale_epoch``."""
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.distributor import master
    from locust_tpu_torch.plan import index_plan, pagerank_plan, tfidf_plan
    from locust_tpu_torch.plan.compile import compile_plan
    from locust_tpu_torch.plan.nodes import Plan, node
    from locust_tpu_torch.serve import ServeClient
    from locust_tpu_torch.serve.cache import bucket_blocks
    from locust_tpu_torch.serve.pool import shard_ranges

    on_card = env.dev.type == "cuda"
    BL, W, E, K = env.BL, env.W, env.E, env.K
    secret = SERVE_SECRET.encode()
    work = os.path.join(env.work, "pool")
    env.pool_tmp = os.path.join(work, "tmp")  # the daemons' TMPDIR, the workers' workdir
    os.makedirs(env.pool_tmp, exist_ok=True)
    env.serve_env = dict(os.environ, LOCUST_SECRET=SERVE_SECRET, TMPDIR=env.pool_tmp,
                         PYTHONPATH=os.pathsep.join(
                             p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    log_path = os.path.join(work, "launches.jsonl")
    kernels = KERNELS
    report = {"card": env.smi}
    rng = np.random.default_rng(10)

    def one_block(i: int) -> bytes:
        words = b" ".join(b"pool%06d" % w for w in rng.integers(0, 10**6, 4))
        return b"\n".join(env.lines[(40 + i) * BL:(41 + i) * BL - 1] + [words]) + b"\n"

    def up_to(nbytes: int, start: int) -> bytes:
        out, total = [], 0
        for ln in env.lines[start:]:
            if total + len(ln) + 1 > nbytes:
                break
            out.append(ln)
            total += len(ln) + 1
        return b"\n".join(out) + b"\n"

    def write(name: str, data: bytes) -> str:
        path = os.path.join(work, name)
        with open(path, "wb") as f:
            f.write(data)
        return path

    def oneshot(name: str, corpus: bytes, argv=()) -> bytes:
        return env.run_cli(f"pool_oneshot_{name}", [*argv, write(f"{name}.txt", corpus),
                                                     *env.cli_extra])

    def wc_want(name: str, corpus: bytes) -> bytes:
        want = _table(oracle_wordcount(corpus.splitlines(), W, E, K).items())
        if oneshot(name, corpus) != want:
            raise AssertionError(f"pool {name}: the one-shot CLI differs from the oracle")
        return want

    def launches() -> dict:
        lines = _launch_lines(log_path)
        return {k: sum(ln[k] for ln in lines) for k in kernels}, lines

    big = up_to(env.serve_big_bytes, 2)
    big_lines = len(big.splitlines())
    big_blocks = -(-big_lines // BL)
    floor = env.pool_shard_min_blocks  # a plan or a job of this many blocks distributes
    plan_corpus = b"\n".join(env.lines[:floor * BL]) + b"\n"
    jobs1 = [(one_block(i), m) for i, m in enumerate(("bitonic", "bitonic", "fused", "fused"))]
    kill_corpus = one_block(4)

    with phase("the serve pool: a daemon with --workers over 2 --serve workers on the card, "
               "one-block bitonic/fused jobs by affinity, a job at the inline cap sharded, "
               "distributed tfidf/index/join/pagerank plans, a worker killed -9 mid-batch"):
        log(f"  card: {env.smi}")
        open(log_path, "w").close()  # every count to 0 just before the pool's processes start
        # Worker 0 holds its 6th serve_batch (after the 4 one-block jobs
        # and its shard of the big job) 3 s: the kill lands inside it,
        # before it folds anything.
        hold = {"seed": 7, "rules": [{"site": "rpc.delay", "action": "delay", "delay_s": 3.0,
                                      "match": {"cmd": "serve_batch"}, "after": 5,
                                      "times": 1}]}
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(_start_serve_worker, env, "pool_worker0", log_path, hold),
                    ex.submit(_start_serve_worker, env, "pool_worker1", log_path)]
            workers = [f.result() for f in futs]
        names = [w[1] for w in workers]
        proc = None
        try:
            proc, port, daemon_s = _start_daemon(
                env, "pool_daemon", ["--workers", ",".join(names), "--shard-min-blocks", str(floor)],
                counted_log=log_path)
            client = ServeClient(("127.0.0.1", port), secret, timeout=600.0)

            def settle():
                """Until no placement is held (a finished job's slot is
                released just after its answer)."""
                deadline = time.monotonic() + 60
                while client.stats()["pool"]["inflight"] != [0, 0]:
                    if time.monotonic() > deadline:
                        raise AssertionError("pool placements still held after 60 s")
                    time.sleep(0.01)

            def run(corpus: bytes, config: dict, **kw):
                t0 = time.perf_counter()
                ack = client.submit(corpus=corpus, config=config, **kw)
                res = client.wait(ack["job_id"], timeout=600.0, poll_s=0.005)
                wall = time.perf_counter() - t0
                st = client.status(ack["job_id"])
                settle()
                return res, st, wall

            answers = []
            for i, (c, m) in enumerate(jobs1):
                res, st, wall = run(c, dict(env.serve_cfg, sort_mode=m))
                if _table(res["pairs"]) != wc_want(f"one{i}", c):
                    raise AssertionError(f"pool one-block job {i} ({m}) differs from the "
                                         "one-shot CLI")
                answers.append({"mode": m, "cache": res["cache"], "placed_on": st["placed_on"],
                                "latency_ms": float(res["latency_ms"]), "wall_s": wall})
            want_place = [(names[0], "cold"), (names[0], "warm")] * 2
            if [(a["placed_on"], a["cache"]) for a in answers] != want_place:
                raise AssertionError(f"pool placements {answers}, expected {want_place}")
            log(f"  4 one-block jobs through serve_batch == oracle == one-shot CLI: "
                f"{json.dumps(answers)}")
            res, st, big_wall = run(big, dict(env.serve_cfg, sort_mode="bitonic"))
            big_want = wc_want("big", big)
            ranges = shard_ranges(big_lines, BL, 2)
            if (_table(res["pairs"]) != big_want or res["cache"] != "shard" or st["shards"] != 2
                    or st["placed_on"] != "shard:" + ",".join(names)):
                raise AssertionError(f"pool big job: cache {res['cache']}, {st['shards']} "
                                     f"shards on {st['placed_on']}, equal "
                                     f"{_table(res['pairs']) == big_want}")
            shard = {"bytes": len(big), "lines": big_lines, "blocks": big_blocks,
                     "ranges": ranges, "latency_ms": float(res["latency_ms"]),
                     "wall_s": big_wall}
            log(f"  a {len(big)} B job ({big_blocks} blocks) sharded over both workers as "
                f"line ranges {ranges}, merged on the daemon: == oracle == one-shot CLI; "
                f"latency {shard['latency_ms']:.3f} ms, client wall {big_wall:.3f} s")

            # Distributed plans.
            plan_ranges = shard_ranges(len(plan_corpus.splitlines()), BL, 2)
            bit_cfg = dict(env.serve_cfg, sort_mode="bitonic")
            fused_cfg = dict(env.serve_cfg, sort_mode="fused")
            join = Plan((
                node("c1", "source", "text"),
                node("m1", "map", "tokenize_count", ("c1",)),
                node("s1", "shuffle", "by_key", ("m1",)),
                node("r1", "reduce", "sum", ("s1",)),
                node("c2", "source", "text"),
                node("m2", "map", "tokenize_count", ("c2",)),
                node("s2", "shuffle", "by_key", ("m2",)),
                node("r2", "reduce", "sum", ("s2",)),
                node("j1", "join", "inner", ("r1", "r2"), combine="sum"),
                node("out", "sink", "table", ("j1",)),
            ))
            solo_join = compile_plan(join, EngineConfig(**fused_cfg), device=env.dev) \
                .run_corpus(plan_corpus).output
            # Four blocks a document: the tf fold's pair table holds the
            # plan corpus's (word, doc) pairs at any block size.
            lpd = 4 * BL
            tf, n_docs = oracle_docs(plan_corpus.splitlines(), lpd, W, E, K)
            edges, n_nodes, e_src, e_dst = web_graph_edges(env.serve_big_bytes)
            iters, damping = 3, 0.85
            plans = (
                ("tfidf", tfidf_plan(lpd), plan_corpus, bit_cfg,
                 oneshot("tfidf", plan_corpus, ["tfidf", "--lines-per-doc", str(lpd),
                                                 "--sort-mode", "bitonic"]),
                 render_tfidf(tf, n_docs)),
                ("index", index_plan(lpd), plan_corpus, bit_cfg,
                 oneshot("index", plan_corpus, ["index", "--lines-per-doc", str(lpd),
                                                 "--sort-mode", "bitonic"]),
                 render_postings(tf)),
                ("join", join, plan_corpus, fused_cfg, solo_join, None),
                ("join_repeat", join, plan_corpus, fused_cfg, solo_join, None),
                ("pagerank", pagerank_plan(iters, damping=damping), edges, dict(env.serve_cfg),
                 None, None),
            )

            def worker_compiles() -> list:
                return [master.rpc(tuple([n.split(":")[0], int(n.split(":")[1])]),
                                   {"cmd": "serve_stats"}, secret, timeout=60)
                        ["exec_cache"]["compiles"] for n in names]

            plan_report = {}
            for name, plan, corpus, cfg_ovr, want, oracle_bytes in plans:
                before = client.stats()["pool"]["plan"]
                compiles0 = worker_compiles()
                res, st, wall = run(corpus, cfg_ovr, plan=plan.to_doc(), no_cache=True)
                after = client.stats()["pool"]["plan"]
                got = res["pairs"][0][0]
                if not res.get("plan") or not st["placed_on"].startswith("plan:") \
                        or res["cache"] != "distributed":
                    raise AssertionError(f"pool plan {name}: placed on {st['placed_on']}, cache "
                                         f"{res['cache']}: not distributed")
                row = {"latency_ms": float(res["latency_ms"]), "wall_s": wall,
                       "placed_on": st["placed_on"], "shards": st["shards"],
                       "stages": after["stages"] - before["stages"],
                       "map_warm_hits": after["map_warm_hits"] - before["map_warm_hits"],
                       "worker_compiles": [b - a for a, b in zip(compiles0, worker_compiles())]}
                if name == "pagerank":
                    solo = compile_plan(plan, EngineConfig(**cfg_ovr), device=env.dev) \
                        .run_corpus(corpus).output
                    got_r, solo_r = _rank_values(got), _rank_values(solo)
                    ref = pagerank_oracle(e_src, e_dst, n_nodes, iters, damping)
                    # Within 1e-5 of the largest rank of the float64
                    # oracle, and the solo engine's bytes exactly: every
                    # step adds in edge order (the gather-add kernel).
                    tol = 1e-5 * float(ref.max())
                    pr_epochs, pr_shards = iters, int(st["shards"])
                    d_solo = float(np.abs(got_r - solo_r).max())
                    d_ref = float(np.abs(got_r - ref).max())
                    differ = sum(a != b for a, b in zip(got.splitlines(), solo.splitlines()))
                    row.update({"nodes": n_nodes, "edges": int(len(e_src)), "iters": iters,
                                "edge_list_bytes": len(edges), "tolerance": tol,
                                "max_abs_delta_vs_solo": d_solo,
                                "max_abs_delta_vs_float64_oracle": d_ref,
                                "lines_differing_from_solo": differ})
                    if len(got_r) != n_nodes or not np.isfinite(got_r).all() \
                            or d_ref > tol + 5e-9:
                        raise AssertionError(f"pool pagerank: {json.dumps(row)}")
                    if got != solo:
                        raise AssertionError(f"pool pagerank differs from the solo engine's "
                                             f"bytes: {json.dumps(row)}")
                elif got != want or (oracle_bytes is not None and got != oracle_bytes):
                    raise AssertionError(f"pool plan {name}: differs from the solo engine / "
                                         f"one-shot CLI ({got == want}) or the oracle")
                plan_report[name] = row
                log(f"  plan {name}: {json.dumps(row)}")
            if plan_report["join_repeat"]["worker_compiles"] != [0, 0] \
                    or plan_report["join_repeat"]["map_warm_hits"] != len(plan_ranges):
                raise AssertionError(f"the repeated join plan was not warm on the workers: "
                                     f"{plan_report['join_repeat']}")
            if client.stats()["pool"]["plan"]["plan_solo_fallbacks"] != 0:
                raise AssertionError("a pool plan was demoted to the daemon's solo engine")
            if on_card:
                smi_apps = _run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                                 "--format=csv,noheader"])
                report["nvidia_smi_compute_apps"] = smi_apps
                log(f"  per-process device memory (nvidia-smi): {smi_apps!r}")

            # Worker 0 killed -9 while it holds a serve_batch.
            t0 = time.perf_counter()
            ack = client.submit(corpus=kill_corpus, config=dict(env.serve_cfg,
                                                                sort_mode="bitonic"))
            deadline = time.monotonic() + 60
            while True:
                st = client.status(ack["job_id"])
                if st["state"] == "running" and st["placed_on"] == names[0]:
                    break
                if time.monotonic() > deadline or st["state"] not in ("queued", "running"):
                    raise AssertionError(f"the held job never ran on worker 0: {st}")
                time.sleep(0.01)
            time.sleep(0.5)
            workers[0][0].kill()  # SIGKILL
            workers[0][0].wait(timeout=30)
            res = client.wait(ack["job_id"], timeout=600.0)
            kill_wall = time.perf_counter() - t0
            st = client.status(ack["job_id"])
            if (_table(res["pairs"]) != wc_want("kill", kill_corpus) or st["placed_on"] != names[1]
                    or st["attempts"] < 1):
                raise AssertionError(f"the job of the killed worker: placed on "
                                     f"{st['placed_on']}, attempts {st['attempts']}")
            pool_stats = client.stats()["pool"]
            log(f"  worker 0 killed -9 inside a serve_batch: retried on {st['placed_on']} "
                f"(attempts {st['attempts']}), == oracle == one-shot CLI, {kill_wall:.3f} s "
                f"from submit; pool stats {json.dumps(pool_stats)}")
            _serve_cli(env, port, ["shutdown"])
            proc.wait(timeout=120)
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            _stop_workers([(p, (n.split(":")[0], int(n.split(":")[1]))) for p, n, _ in workers
                           if p.poll() is None], SERVE_SECRET)
        got_launches, lines = launches()  # and read just after the processes end
        want_launches = {
            "tokenize": 0,
            # 2 one-block jobs; the big job's shards (each folds its
            # bucket) and their merge on the daemon; the tf fold of every
            # map split of tfidf and index (one sort per block); the job
            # of the killed worker, folded once on the survivor.
            "bitonic_sort": 2 + sum(bucket_blocks(-(-(b - a) // BL)) for a, b in ranges) + 1
            + 2 * sum(-(-(b - a) // BL) for a, b in plan_ranges) + 1,
            # 2 one-block jobs; the map splits of the join plan and of its
            # repeat (each folds its bucket).
            "fused_fold": 2 + 2 * sum(bucket_blocks(-(-(b - a) // BL)) for a, b in plan_ranges),
            # One gather-add per rank shard and epoch of the PageRank plan.
            "pagerank": pr_epochs * pr_shards,
            "partition": 0,
        }
        mem = {}
        for ln in lines:
            who = f"{'worker' if ln['module'].endswith('worker') else 'daemon'}:{ln['pid']}"
            mem[who] = max(mem.get(who) or 0, ln.get("max_memory_reserved") or 0) or None
        env.by_path["pool"] = got_launches
        report.update({"workers_start_s": [w[2] for w in workers], "daemon_start_s": daemon_s,
                       "one_block_jobs": answers, "sharded_job": shard, "plans": plan_report,
                       "killed_worker_job_s": kill_wall, "pool_stats": pool_stats,
                       "launches": got_launches, "expected_launches": want_launches,
                       "max_memory_reserved_by_process": mem})
        log(f"  launches summed over the daemon and the workers: {got_launches}, expected "
            f"{want_launches}; peak reserved device memory by process {json.dumps(mem)}")
        if on_card and got_launches != want_launches:
            raise AssertionError(f"pool launches {got_launches} != {want_launches}")

    with phase("failover: a primary with --journal-dir --ship-to, a standby with --standby-of "
               "--lease; a job at the inline cap --no-wait, the primary killed -9 while it "
               "runs, the lease promotes the standby, result --wait under the original id; a "
               "ship of the old epoch refused with stale_epoch"):
        open(log_path, "w").close()
        big_file = write("failover_big.txt", big)
        lease = env.pool_lease_s
        held = json.dumps({"rules": [{"site": "serve.dispatch", "action": "delay",
                                      "delay_s": 30.0, "times": 1}]})
        standby = primary = None
        try:
            standby, s_port, standby_s = _start_daemon(
                env, "failover_standby", ["--journal-dir", os.path.join(work, "j_standby"),
                                          "--standby-of", "127.0.0.1:9", "--lease", str(lease)],
                counted_log=log_path)
            primary, p_port, primary_s = _start_daemon(
                env, "failover_primary", ["--journal-dir", os.path.join(work, "j_primary"),
                                          "--ship-to", f"127.0.0.1:{s_port}", "--fault-plan",
                                          held], counted_log=log_path)
            sclient = ServeClient(("127.0.0.1", s_port), secret, timeout=60.0)
            pclient = ServeClient(("127.0.0.1", p_port), secret, timeout=60.0)
            job_id = _serve_cli(env, p_port, ["submit", big_file, "--no-wait", "--sort-mode",
                                              "bitonic", *env.serve_submit_extra]
                                ).stdout.decode().strip()
            deadline = time.monotonic() + 60
            while True:
                rep = sclient.stats()["replication"]
                state = pclient.status(job_id)["state"]
                if rep["standby"]["applied_records"] >= 1 and \
                        rep["standby"]["missing_spills"] == 0 and state == "running":
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"failover: never replicated and running: {rep}, "
                                         f"{state}")
                time.sleep(0.01)
            if rep["role"] != "standby":
                raise AssertionError(f"the standby flapped to {rep['role']} before the kill")
            primary.kill()  # SIGKILL
            primary.wait(timeout=30)
            t_kill = time.perf_counter()
            deadline = time.monotonic() + lease + 60
            while sclient.stats()["replication"]["role"] != "primary":
                if time.monotonic() > deadline:
                    raise AssertionError("the standby never promoted")
                time.sleep(0.01)
            promote_s = time.perf_counter() - t_kill
            out = _serve_cli(env, s_port, ["result", job_id, "--wait", "--timeout", "600"])
            answer_s = time.perf_counter() - t_kill
            if out.stdout != big_want:
                raise AssertionError("failover: the promoted standby's answer differs from the "
                                     "one-shot CLI")
            rep = sclient.stats()["replication"]
            fenced = sclient._rpc_one(("127.0.0.1", s_port), {"cmd": "ship", "_epoch": 1,
                                                             "from": "127.0.0.1:9"})
            if fenced.get("code") != "stale_epoch" or rep["epoch"] < 2:
                raise AssertionError(f"failover: old-epoch ship answered {fenced}, epoch "
                                     f"{rep['epoch']}")
            _serve_cli(env, s_port, ["shutdown"])
            standby.wait(timeout=120)
        finally:
            for p in (primary, standby):
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        got_f, _ = launches()
        want_f = {"tokenize": 0, "bitonic_sort": bucket_blocks(big_blocks), "fused_fold": 0,
                  "pagerank": 0, "partition": 0}
        env.by_path["failover"] = got_f
        report["failover"] = {"standby_start_s": standby_s, "primary_start_s": primary_s,
                              "lease_s": lease, "kill_to_promoted_s": promote_s,
                              "kill_to_answer_s": answer_s, "epoch": rep["epoch"],
                              "old_epoch_ship": fenced.get("code"), "launches": got_f,
                              "expected_launches": want_f}
        log(f"  standby up {standby_s:.3f} s, primary {primary_s:.3f} s; primary killed -9 "
            f"with the job running; promoted by the {lease} s lease {promote_s:.3f} s after the "
            f"kill (epoch {rep['epoch']}); result --wait under id {job_id} == one-shot CLI "
            f"{answer_s:.3f} s after the kill; old-epoch ship -> {fenced.get('code')}; "
            f"launches {got_f}, expected {want_f} (card: {env.smi})")
        if on_card and got_f != want_f:
            raise AssertionError(f"failover launches {got_f} != {want_f}")
    return report


def _mesh_world(env, name: str, n: int, argv: list[str], log_path: str, plan=None,
                module: str = "locust_tpu_torch.cli", threads: int | None = None):
    """``n`` processes of ``python -m locust_tpu_torch ... --mesh`` (or of
    ``module``) joined through ``--coordinator/--num-processes/
    --process-id``, each under the counting wrapper (``threads``: each
    process's CPU thread count); returns ``(rcs, stdouts, launch lines,
    wall s)``."""
    from locust_tpu_torch.parallel.mesh import free_port

    open(log_path, "w").close()  # emptied just before the world
    coord = f"127.0.0.1:{free_port()}"
    extra = [] if plan is None else ["--fault-plan", json.dumps(plan)]
    proc_env = env.mesh_env if threads is None else dict(env.mesh_env,
                                                          OMP_NUM_THREADS=str(threads))
    procs, outs = [], []
    t0 = time.perf_counter()
    for pid in range(n):
        out_path = os.path.join(env.work, f"{name}.{pid}.out")
        outs.append(out_path)
        with open(out_path, "wb") as o, open(out_path[:-4] + ".err", "wb") as e:
            procs.append(subprocess.Popen(
                [*_counted(log_path, module), *argv, "--coordinator", coord,
                 "--num-processes", str(n), "--process-id", str(pid), *extra],
                cwd=HERE, env=proc_env, stdout=o, stderr=e))
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    wall = time.perf_counter() - t0
    stdouts = []
    for path in outs:
        with open(path, "rb") as f:
            stdouts.append(f.read())
    return [p.returncode for p in procs], stdouts, _launch_lines(log_path), wall


def _mesh_env() -> dict:
    """The environment of a mesh world's processes: gloo on the loopback,
    this checkout first on the path."""
    return dict(os.environ, GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
                PYTHONPATH=os.pathsep.join(p for p in (HERE, os.environ.get("PYTHONPATH")) if p))


def _check_partition_lines(name: str, lines: list, on_card: bool) -> None:
    """On the card, every process of a world that launched the partition
    kernel held it against its plain version at least once."""
    if on_card and any(ln["partition"] and not ln.get("partition_checked") for ln in lines):
        raise AssertionError(f"{name}: a process launched the partition kernel unchecked")


def mesh_phase(env) -> dict:
    """The mesh tier on the card (``locust_tpu_torch.parallel``), WordCount
    through the CLI at its defaults over the corpus file:

    1. ``--mesh`` alone, one rank per card: a world of one in this process
       on a one-card host (NCCL), under ``bitonic`` (kernels A and B) and
       ``fused`` (kernel C, ``fused_kernel == "mesh"``), beside the
       single-device CLI;
    2. a world of 2 processes sharing the card (gloo, the tensors staged
       through the host) under ``bitonic`` and ``fused``; the ``bitonic``
       run again with ``--checkpoint-dir``, both ranks crashed by an
       ``io.ckpt_write`` fault when they write a snapshot, and resumed;
    3. ``--slices 2`` over 2 processes and over 4 (the hierarchical engine).

    Every stdout is the single-device CLI's, process 0's alone; each
    process counts its launches under the wrapper, and their sums must
    equal the prediction: per rank and round kernel A once and kernel B
    twice (the local combine and the merge, once more per drain round)
    under ``bitonic``, kernel C once under ``fused``; the hierarchical
    combine one more sort per rank; and under every mode the partition
    kernel once per rank and shuffle round, drain rounds included.  On
    the card each process holds the partition kernel against its plain
    version at the first call of each shape (``_check_partition_calls``)."""
    from locust_tpu_torch.parallel.mesh import COMM

    on_card = env.dev.type == "cuda"
    checked = _check_partition_calls() if on_card else []
    BL, n_lines = env.BL, len(env.lines)
    work = os.path.join(env.work, "mesh")
    os.makedirs(work, exist_ok=True)
    log_path = os.path.join(work, "launches.jsonl")
    env.mesh_env = _mesh_env()
    report = {"card": env.smi}

    def rounds(world: int) -> int:
        return -(-n_lines // (world * BL))

    def predict(mode: str, world: int, slices: int = 0, drains: int = 0,
                refolds: int = 0, from_round: int = 0, counted: int | None = None) -> dict:
        """Launches of ``counted`` ranks (all ``world`` by default)."""
        r, k = rounds(world) - from_round, world if counted is None else counted
        shuffles = {"partition": k * (r + drains)}
        if mode == "fused" and on_card:
            return {"tokenize": refolds, "fused_fold": k * r, **shuffles}
        if mode == "fused":  # a CPU rank demotes to hasht: the map, no sort
            return {"tokenize": k * r, **shuffles}
        return {"tokenize": k * r,
                "bitonic_sort": k * (2 * r + drains) + (k if slices else 0), **shuffles}

    def check(name, stdout, got, want):
        env.by_path[name] = got
        env.expected[name] = want
        if stdout != env.want:
            raise AssertionError(f"mesh {name}: stdout differs from the single-device CLI's")
        env.check_counts(name)

    # ``--mesh`` alone is one rank per visible card: a world of one in this
    # process on a one-card host; on a host with more cards the CLI starts
    # the other ranks itself (their launches are not counted here, rank 0's
    # are).
    cards = env.torch.cuda.device_count() if on_card else 1
    with phase(f"the mesh: --mesh alone, a world of {cards} rank(s) (rank 0 in this "
               "process), bitonic and fused"):
        for mode in ("bitonic", "fused"):
            argv = [env.corpus_file, "--sort-mode", mode, *env.cli_extra]
            t0 = time.perf_counter()
            env.run_cli(f"single_{mode}_no_timing", argv + ["--no-timing"])
            single_s = time.perf_counter() - t0
            with _mesh_recorder() as rec:
                t0 = time.perf_counter()
                out = env.run_cli(f"mesh_w1_{mode}", argv + ["--mesh"])
                wall = time.perf_counter() - t0
            (r,) = rec
            check(f"mesh_w1_{mode}", out, env.by_path[f"mesh_w1_{mode}"],
                  predict(mode, cards, drains=r["drain_rounds"], refolds=r["fused_refolds"],
                          counted=1))
            env.expected[f"single_{mode}_no_timing"] = (
                {"fused_fold": env.nblocks} if mode == "fused"
                else {"tokenize": env.nblocks, "bitonic_sort": env.nblocks})
            env.check_counts(f"single_{mode}_no_timing")
            want_backend = "nccl" if on_card else "gloo"
            if r["backend"] != want_backend or r["size"] != cards or r["drain_rounds"] != 0 or (
                    mode == "fused" and r["fused_kernel"] != ("mesh" if on_card else None)):
                raise AssertionError(f"mesh_w1_{mode}: {r}")
            report[f"w1_{mode}"] = {"wall_s": wall, "single_device_cli_s": single_s,
                                    "rounds": rounds(cards), **r}
            log(f"  --mesh, {mode}: a world of {cards} ({r['backend']}, rank 0 on "
                f"{r['device']}), {rounds(cards)} rounds, stdout == single-device CLI; "
                f"{wall:.3f} s in process "
                f"against the single-device CLI's {single_s:.3f} s (--no-timing); "
                f"fused_kernel {r['fused_kernel']}, launches {env.by_path[f'mesh_w1_{mode}']}")

    def world_run(name, n, mode, extra=(), plan=None, from_round=0, slices=0):
        argv = [env.corpus_file, "--mesh", "--sort-mode", mode, *extra, *env.cli_extra]
        rcs, outs, lines, wall = _mesh_world(env, name, n, argv, log_path, plan)
        if plan is not None:
            return rcs, lines
        if rcs != [0] * n or len(lines) != n:
            errs = []
            for pid in range(n):
                with open(os.path.join(env.work, f"{name}.{pid}.err"), "rb") as f:
                    errs.append(f.read()[-1500:])
            raise AssertionError(f"mesh {name}: exit codes {rcs}, {len(lines)} launch lines: "
                                 f"{errs}")
        recs = sorted((ln["mesh"][0] for ln in lines), key=lambda r: r["rank"])
        drains = recs[0]["drain_rounds"]
        got = {k: sum(ln[k] for ln in lines) for k in KERNELS}
        check(name, outs[0], got, predict(mode, n, slices, drains,
                                          sum(r["fused_refolds"] for r in recs), from_round))
        if any(o for o in outs[1:]):
            raise AssertionError(f"mesh {name}: a rank other than 0 printed")
        _check_partition_lines(name, lines, on_card)
        backend = "nccl" if on_card and n <= env.torch.cuda.device_count() else "gloo"
        for r in recs:
            if r["backend"] != backend or r["size"] != n or r["drain_rounds"] != drains or (
                    mode == "fused" and r["fused_kernel"] != ("mesh" if on_card else None)):
                raise AssertionError(f"mesh {name}: rank record {r}")
        a2a = [ln["comm"]["all_to_all"] for ln in lines]
        per_round = rounds(n) - from_round
        row = {"wall_s": wall, "processes": n, "rounds": per_round, "drain_rounds": drains,
               "backend": recs[0]["backend"], "axes": recs[0]["axes"],
               "launches": got, "expected_launches": dict(env.expected[name]),
               "fused_kernel": recs[0]["fused_kernel"],
               "all_to_all_calls_per_rank": [c["calls"] for c in a2a],
               "all_to_all_bytes_per_round_per_rank": [
                   c["bytes"] / max(c["calls"], 1) for c in a2a],
               "all_to_all_ms_per_round_per_rank": [
                   1e3 * c["s"] / max(c["calls"], 1) for c in a2a],
               "all_gather_bytes_per_rank": [ln["comm"]["all_gather"]["bytes"] for ln in lines],
               "max_memory_reserved_by_process": [ln.get("max_memory_reserved") for ln in lines],
               "partition_shapes_checked": [ln.get("partition_checked") for ln in lines]}
        report[name] = row
        log(f"  {name}: {n} processes ({row['backend']}, axes {row['axes']}), {per_round} "
            f"rounds, drains {drains}, stdout == single-device CLI, {wall:.3f} s; launches "
            f"{got} == prediction; all-to-all per round and rank "
            f"{row['all_to_all_bytes_per_round_per_rank']} B in "
            f"{[round(v, 3) for v in row['all_to_all_ms_per_round_per_rank']]} ms; peak "
            f"reserved {row['max_memory_reserved_by_process']}")
        return row

    with phase("the mesh: a world of 2 processes (gloo when they share a card), bitonic and "
               "fused; a checkpointed run crashed at a snapshot and resumed"):
        t0 = time.perf_counter()
        single = subprocess.run([sys.executable, "-m", "locust_tpu_torch", env.corpus_file,
                                 "--no-timing", *env.cli_extra], cwd=HERE, env=env.mesh_env,
                                capture_output=True, timeout=600)
        report["single_device_cli_process_s"] = time.perf_counter() - t0
        if single.returncode != 0 or single.stdout != env.want:
            raise AssertionError("the single-device CLI process differs from the oracle")
        for mode in ("bitonic", "fused"):
            world_run(f"mesh_w2_{mode}", 2, mode)
        every, crash = env.mesh_ckpt_every, env.mesh_crash_gen
        ckpt = ["--checkpoint-dir", os.path.join(work, "ckpt"), "--checkpoint-every", str(every)]
        plan = {"rules": [{"site": "io.ckpt_write", "action": "crash",
                           "match": {"generation": crash}, "times": 1}]}
        rcs, lines = world_run("mesh_w2_crashed", 2, "bitonic", ckpt, plan=plan)
        crashed = {k: sum(ln[k] for ln in lines) for k in KERNELS}
        if 0 in rcs or len(lines) != 2:
            raise AssertionError(f"mesh_w2_crashed: exit codes {rcs}, {len(lines)} lines")
        row = world_run("mesh_w2_resumed", 2, "bitonic", ckpt, from_round=crash - every)
        row["crashed_at_generation"], row["crashed_launches"] = crash, crashed
        log(f"  both ranks crashed writing snapshot {crash} (exit codes {rcs}, launches "
            f"{crashed}); the resume folded rounds {crash - every} on")

    with phase("the mesh: --slices 2 over 2 processes and over 4 (hierarchical)"):
        world_run("mesh_hier_2x1", 2, "bitonic", ["--slices", "2"], slices=2)
        world_run("mesh_hier_2x2", 4, "bitonic", ["--slices", "2"], slices=2)
    report["comm_in_this_process"] = COMM
    report["partition_shapes_checked_in_this_process"] = list(checked)
    if on_card and not checked:
        raise AssertionError("the mesh: no partition call on the card was checked")
    log(f"  the partition kernel == its plain version at {len(checked)} shape(s) in this "
        f"process: {checked}")
    return report


# The sample sort's rows: at least 1 Mi of the corpus's tokens.
SORT_ROWS = (1 << 20) + 4096


def sort_world(args: list[str]) -> int:
    """``chip_smoke.py --counted-child LOG chip_smoke:sort_world OUTDIR
    BACKEND --coordinator C --num-processes N --process-id I``: one rank
    of the sample sort's world.  Sorts ``OUTDIR/rows.npy`` with
    ``DistributedSort.sort_rows`` and the strings of ``OUTDIR/dups.npy``
    with ``sort_strings`` from ``skew_factor`` 1; process 0 writes
    ``OUTDIR/sorted.npz``: the sorted keys as rows, their values, the
    overflow and the ``sort_rows`` calls ``sort_strings`` took."""
    outdir, backend = args[0], args[1]
    coord, n, pid = args[args.index("--coordinator") + 1], int(
        args[args.index("--num-processes") + 1]), int(args[args.index("--process-id") + 1])
    from locust_tpu_torch.apps.sample_sort import DistributedSort, sort_strings
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.core import bytes_ops
    from locust_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.initialize_multihost(coord, n, pid, device=backend)
    try:
        mesh = mesh_mod.make_mesh(device=backend)
        out = _sort_checks(mesh, np.load(os.path.join(outdir, "rows.npy")),
                           bytes_ops.rows_to_strings(np.load(os.path.join(outdir, "dups.npy"))),
                           EngineConfig(key_width=32), DistributedSort, sort_strings, bytes_ops,
                           skew=1.0)
        if mesh.rank == 0:
            np.savez(os.path.join(outdir, "sorted.npz"), **out)
    finally:
        mesh_mod.shutdown()
    return 0


def _sort_checks(mesh, rows, dups, cfg, DistributedSort, sort_strings, bytes_ops, skew):
    """The sort's two runs on ``mesh``: ``sort_rows`` of ``rows`` (keys as
    rows and values, in order, and the overflow) and ``sort_strings`` of
    ``dups`` from ``skew`` (the sorted strings as rows, and the number of
    ``sort_rows`` calls it took)."""
    res = DistributedSort(mesh, cfg, -(-rows.shape[0] // mesh.size)).sort_rows(rows)
    pairs = res.to_host_sorted()
    calls, real = [], DistributedSort.sort_rows

    def counting(self, *a, **k):
        got = real(self, *a, **k)
        calls.append(got.overflow)
        return got

    DistributedSort.sort_rows = counting
    try:
        strings = sort_strings(dups, mesh, cfg, skew_factor=skew)
    finally:
        DistributedSort.sort_rows = real
    return {"keys": bytes_ops.strings_to_rows([k for k, _ in pairs], cfg.key_width),
            "values": np.array([v for _, v in pairs], np.int64),
            "overflow": np.int64(res.overflow),
            "dups_sorted": bytes_ops.strings_to_rows(strings, cfg.key_width),
            "attempt_overflows": np.array(calls, np.int64)}


def _check_sort(name: str, got: dict, rows: np.ndarray, dups: np.ndarray) -> dict:
    """The sorted keys equal numpy's lexsort of the same rows; each run
    of equal keys carries the same multiset of values (the row indices);
    the duplicate-heavy strings sort to numpy's order after one retry."""
    idx = np.arange(rows.shape[0])
    cols = [rows[:, c] for c in range(rows.shape[1] - 1, -1, -1)]
    order = np.lexsort([idx, *cols])
    keys, values = got["keys"], got["values"]
    if int(got["overflow"]) or not np.array_equal(keys, rows[order]):
        raise AssertionError(f"{name}: sorted keys differ from numpy's lexsort "
                             f"(overflow {int(got['overflow'])})")
    by_run = np.lexsort([values, *[keys[:, c] for c in range(keys.shape[1] - 1, -1, -1)]])
    if not np.array_equal(values[by_run], idx[order]):
        raise AssertionError(f"{name}: a run of equal keys carries other values")
    d_order = np.lexsort([dups[:, c] for c in range(dups.shape[1] - 1, -1, -1)])
    attempts = [int(v) for v in got["attempt_overflows"]]
    if not np.array_equal(got["dups_sorted"], dups[d_order]):
        raise AssertionError(f"{name}: sort_strings of the duplicate-heavy list differs")
    if len(attempts) != 2 or attempts[0] == 0 or attempts[1] != 0:
        raise AssertionError(f"{name}: sort_strings took attempts with overflows {attempts}, "
                             "expected one retry")
    return {"rows": int(rows.shape[0]), "attempt_overflows": attempts}


def mesh_apps_phase(env) -> dict:
    """The mesh apps on the card, each through the entry point a user
    calls and each path's launches counted exactly:

    1. ``pagerank --mesh`` over the web-sized graph, 20 iterations, in a
       world of 1 in this process and worlds of 2 and 4 processes sharing
       the card (gloo): each stdout the same world's ``--backend cpu``
       stdout, the gather-add launched twice per rank and iteration (the
       send and the receive sum of ``ShardedPageRank``); the largest
       |rank - float64 oracle| and the lines differing from the
       single-device CLI are reported; ``DistributedPageRank.run`` in a
       world of 1 in this process, bit for bit against the CPU world of 1,
       one gather-add per iteration; and the gather-add alone at a world
       of 2's send-slot and receive shapes (sources and rows two index
       spaces, the receive sum unweighted), bit for bit against the CSR
       walk at int32 and int64, with its times and bounds;
    2. ``index --mesh`` over the corpus file, one document per block, in
       worlds of 1 and 2: the oracle's bytes, kernel A once per rank and
       round, the partition kernel once per rank and shuffle round (drain
       rounds included);
    3. ``compile_plan(wordcount_plan(), cfg, mesh=True)`` in this process
       under ``bitonic`` (kernels A and B) and ``hasht`` (rewritten to
       ``fused``: kernel C per round): the CLI's bytes; the partition
       kernel once per shuffle round;
    4. ``DistributedSort.sort_rows`` over >= 1 Mi of the corpus's tokens
       and ``sort_strings`` over a duplicate-heavy list that overflows once
       and is retried, in a world of 1 in this process and of 2 processes:
       keys in numpy's lexsort order, each run of equal keys with its
       values as a multiset; the partition kernel once per rank and
       ``sort_rows`` call.

    On the card every process holds the partition kernel against its
    plain version at the first call of each shape
    (``_check_partition_calls``)."""
    from locust_tpu_torch.apps.pagerank import DistributedPageRank, ShardedPageRank
    from locust_tpu_torch.apps.sample_sort import DistributedSort, sort_strings
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.core import bytes_ops
    from locust_tpu_torch.ops.kernels.pagerank import (Grouping, csr_walk_reference,
                                                       gather_add)
    from locust_tpu_torch.parallel import mesh as mesh_mod
    from locust_tpu_torch.plan import wordcount_plan
    from locust_tpu_torch.plan.compile import compile_plan
    from locust_tpu_torch.utils import roofline

    t_phase = time.perf_counter()
    torch, dev = env.torch, env.dev
    on_card = dev.type == "cuda"
    work = os.path.join(env.work, "mesh_apps")
    os.makedirs(work, exist_ok=True)
    log_path = os.path.join(work, "launches.jsonl")
    env.mesh_env = _mesh_env()
    report = {"card": env.smi}
    cpu_threads = max(1, (os.cpu_count() or 2) // 2)
    iters = 20
    checked = _check_partition_calls() if on_card else []

    def world(name, n, argv, cpu=False, module="locust_tpu_torch.cli"):
        """A world of ``n`` processes; its rank 0's stdout, the launches
        summed over its processes and its wall seconds (and the launch
        lines, in ``world.lines``)."""
        rcs, outs, lines, wall = _mesh_world(env, name, n, argv, log_path, module=module,
                                             threads=max(1, cpu_threads // n) if cpu else None)
        if rcs != [0] * n or len(lines) != n:
            errs = []
            for pid in range(n):
                with open(os.path.join(env.work, f"{name}.{pid}.err"), "rb") as f:
                    errs.append(f.read()[-1500:])
            raise AssertionError(f"{name}: exit codes {rcs}, {len(lines)} launch lines: {errs}")
        if any(o for o in outs[1:]):
            raise AssertionError(f"{name}: a rank other than 0 printed")
        _check_partition_lines(name, lines, on_card)
        world.lines = lines
        return outs[0], {k: sum(ln[k] for ln in lines) for k in KERNELS}, wall

    def check(name, got, want):
        env.by_path[name], env.expected[name] = got, want
        env.check_counts(name)

    # ---- 1. pagerank --mesh
    graph = getattr(env, "pagerank_graph", None)
    if graph is None:  # chip_mesh.py's mesh_apps alone
        n, src, dst = synthetic_web_graph()
        path = os.path.join(env.work, "edges.txt")
        with open(path, "wb") as f:
            f.write("".join(f"{a}\t{b}\n" for a, b in zip(src.tolist(), dst.tolist())).encode())
        oracle = pagerank_oracle(src, dst, n, iters, 0.85)
    else:
        n, src, dst, path, oracle = graph
    argv = ["pagerank", path, "--num-nodes", str(n), "--num-iters", str(iters), "--mesh"]
    pr_extra = [] if on_card else ["--backend", "cpu"]  # pagerank takes no block flags
    # The single-device CLI, timed beside the worlds: pagerank_phase's run,
    # else (chip_mesh.py's mesh_apps alone) one here.
    single, single_s = getattr(env, "pagerank_single", (None, None))
    if single is None:
        t0 = time.perf_counter()
        single = env.run_cli("mesh_apps_pagerank_single", argv[:-1] + pr_extra)
        single_s = time.perf_counter() - t0
        check("mesh_apps_pagerank_single", env.by_path["mesh_apps_pagerank_single"],
              {"pagerank": iters})
    single_rows = single.splitlines()
    d_single = float(np.abs(np.array([float(r.split(b"\t")[1]) for r in single_rows])
                            - oracle).max())
    pr = {"max_abs_delta_single_device_cli_vs_float64_oracle": d_single,
          "single_device_cli_s": single_s}
    log(f"  the single-device pagerank CLI: {single_s:.3f} s in process")
    # ``--mesh`` alone is one rank per visible card: a world of one in
    # this process on a one-card host; on a host of more cards the CLI
    # starts the other ranks itself, and rank 0's launches are counted.
    cards = torch.cuda.device_count() if on_card else 1
    worlds = ("a world of 1 in process, worlds of 2 and 4 processes sharing the card"
              if cards == 1 else f"--mesh alone, a world of {cards} (one rank a card)")
    with phase(f"the mesh apps: pagerank --mesh over {n} nodes, {len(src)} edges, {iters} "
               f"iterations, {worlds}, each against the same world on the CPU"):
        for w in (cards, 2, 4) if cards == 1 else (cards,):
            name = f"mesh_pagerank_w{w}"
            if w == cards:
                t0 = time.perf_counter()
                out = env.run_cli(name, argv + pr_extra)
                wall = time.perf_counter() - t0
                got, ranks_counted = env.by_path[name], 1
                t0 = time.perf_counter()
                cpu = (env.run_cli(name + "_cpu", argv + ["--backend", "cpu"]) if w == 1 else
                       world(name + "_cpu", w, argv + ["--backend", "cpu"], cpu=True)[0])
                cpu_wall = time.perf_counter() - t0
            else:
                out, got, wall = world(name, w, argv + pr_extra)
                cpu, _, cpu_wall = world(name + "_cpu", w, argv + ["--backend", "cpu"], cpu=True)
                ranks_counted = w
            check(name, got, {"pagerank": 2 * iters * ranks_counted})
            rows = out.splitlines()
            if len(rows) != n or out != cpu:
                bad = sum(a != b for a, b in zip(rows, cpu.splitlines()))
                raise AssertionError(f"{name}: {len(rows)} rows; stdout differs from the CPU "
                                     f"world of {w}: {bad} lines")
            printed = np.array([float(r.split(b"\t")[1]) for r in rows])
            d_oracle = float(np.abs(printed - oracle).max())
            # Reported; a sanity bound only: a sum over the ranks rounds
            # otherwise than one device's, not ten times as far.
            tol = 10 * d_single + 1e-5 * float(oracle.max())
            if not np.isfinite(printed).all() or d_oracle > tol:
                raise AssertionError(f"{name}: |delta| {d_oracle:.3e} against the oracle, above "
                                     f"{tol:.3e}")
            differ = sum(a != b for a, b in zip(rows, single_rows))
            pr[f"w{w}"] = {"wall_s": wall, "cpu_world_wall_s": cpu_wall, "launches": got,
                           "max_abs_delta_printed_vs_float64_oracle": d_oracle,
                           "lines_differing_from_single_device_cli": differ,
                           "lines_differing_from_cpu_world": 0}
            log(f"  world of {w}: stdout == the CPU world's ({n} lines), {wall:.3f} s (the CPU "
                f"world {cpu_wall:.3f} s); printed ranks vs float64 oracle {d_oracle:.6e} "
                f"(the single-device CLI's {d_single:.6e}; sanity bound {tol:.3e}); {differ} of "
                f"{n} lines differ from the single-device "
                f"CLI (a two-level sum rounds otherwise); launches {got}")

    with phase(f"the mesh apps: DistributedPageRank.run over the same graph, {iters} "
               "iterations, a world of 1 in process, against the CPU world of 1's bits"):
        def edge_sharded(device):
            try:
                return DistributedPageRank(mesh_mod.make_mesh(device=device), n).run(
                    src, dst, iters)
            finally:
                mesh_mod.shutdown()

        t0 = time.perf_counter()
        got_r, got = counted(lambda: edge_sharded(dev))
        wall = time.perf_counter() - t0
        check("mesh_distributed_pagerank_w1", got, {"pagerank": iters})
        want_r = edge_sharded("cpu")
        if got_r.shape != (n,) or not np.isfinite(got_r).all():
            raise AssertionError("DistributedPageRank: ranks not finite or of the wrong shape")
        if not np.array_equal(got_r, want_r):
            raise AssertionError(f"DistributedPageRank: the card differs from the CPU world of "
                                 f"1 on {int((got_r != want_r).sum())} of {n} ranks")
        d_oracle = float(np.abs(got_r.astype(np.float64) - oracle).max())
        pr["distributed_w1"] = {"wall_s": wall, "launches": got,
                                "max_abs_delta_vs_float64_oracle": d_oracle}
        log(f"  ranks == the CPU world of 1's, bit for bit; vs float64 oracle {d_oracle:.6e}; "
            f"{wall:.3f} s; launches {got}")

    with phase("the mesh apps: the gather-add at a world of 2's send-slot and receive shapes "
               "(two index spaces), bit for bit against the CSR walk at int32 and int64"):
        sp = ShardedPageRank(mesh_mod.Mesh(0, 2, ("data",), (2,), {"data": None}, dev, "gloo"), n)
        plan = sp._build_plan(src, dst)
        npd, n_slots = sp.npd, 2 * plan["cap"]
        send_g, recv_g = sp.groupings(plan)
        rng = np.random.default_rng(5)
        deg = np.bincount(src, minlength=2 * npd)[:npd].astype(np.float32)
        inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0).astype(np.float32)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        shapes = {}
        # The receive sum is unweighted: its received slots are products.
        for what, g, r, i in (
                ("send", send_g, rng.random(npd).astype(np.float32) / n, inv),
                ("receive", recv_g, rng.random(n_slots).astype(np.float32) / n, None)):
            weighted = i is not None
            r, i = torch.from_numpy(r).to(dev), torch.from_numpy(i).to(dev) if weighted else None
            rows_n, n_src, edges = g.schedule.shape[0], r.shape[0], g.src_by_dst.shape[0]
            err = 0.0
            for g_ in (g, Grouping(*(t.to(torch.int64) for t in g[:3]), g.warp_rows)):
                got, want = gather_add(zero, *g_, r, i), csr_walk_reference(zero, *g_, r, i)
                if on_card:
                    torch.cuda.synchronize()
                err = max(err, float((got - want).abs().max()) if rows_n else 0.0)
                if not torch.equal(got, want):
                    raise AssertionError(f"gather-add, {what} shape ({g_.offsets.dtype}): "
                                         f"differs from the CSR walk, max abs err {err}")
            row = {"rows": rows_n, "sources": n_src, "edges": edges, "warp_rows": g.warp_rows,
                   "weighted": weighted, "max_abs_err": err}
            if on_card:
                s_t = g.src_by_dst.long()
                d_t = torch.repeat_interleave(g.schedule.long(),
                                              (g.offsets[1:] - g.offsets[:-1]).long())

                def kernel(g=g, r=r, i=i):
                    return gather_add(zero, *g, r, i)

                def library(r=r, i=i, s_t=s_t, d_t=d_t, rows_n=rows_n):
                    c = r[s_t] * i[s_t] if i is not None else r[s_t]
                    return zero.expand(rows_n).clone().index_add_(0, d_t, c)

                k_ms = cuda_ms(torch, kernel)
                p_ms = cuda_ms(torch, lambda: csr_walk_reference(zero, *g, r, i), reps=3,
                               warmup=1)
                l_ms = cuda_ms(torch, library)
                k_ops, k_dev, k_own = call_profile(torch, kernel, "gather_add_kernel")
                longest = int((g.offsets[1:] - g.offsets[:-1]).max()) if rows_n else 0
                b, by = bound_ms(
                    roofline.pagerank_gather_min_bytes(rows_n, edges, 4, n_src, weighted),
                    roofline.pagerank_gather_min_ops(edges, weighted))
                clock = sm_clock_mhz(torch, kernel)
                chain = roofline.pagerank_chain_min_ms(longest, clock)
                row.update({"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                            "device_ops_per_call": k_ops, "device_ms": k_dev,
                            "kernel_device_ms": k_own, "bound_ms": b, "bound_by": by,
                            "chain_bound_ms": chain, "longest_row": longest,
                            "sm_clock_mhz": clock})
                if k_ops != 1:
                    raise AssertionError(f"a gather-add call is {k_ops:g} device ops, not 1")
                log(f"  {what}: {rows_n} rows over {n_src} sources, {edges} edges, "
                    f"{g.warp_rows} warp rows: kernel {k_ms:.4f} ms, own {k_own:.4f} ms; "
                    f"plain {p_ms:.4f} ms; index_add_ {l_ms:.4f} ms; bounds: bytes {b:.6f} ms "
                    f"({by}), chain {chain:.6f} ms ({longest} adds at {clock:g} MHz); "
                    f"card {env.smi}")
            else:
                log(f"  {what}: {rows_n} rows over {n_src} sources, {edges} edges: == CSR walk")
            shapes[what] = row
        pr["gather_add_world2"] = shapes
    report["pagerank"] = pr

    # ---- 2. index --mesh
    want = getattr(env, "postings_want", None)
    if want is None:
        want = render_postings(oracle_docs(env.lines, env.BL, 128, 20, 32)[0])
    rounds = lambda w: -(-len(env.lines) // (w * env.BL))  # noqa: E731
    argv = ["index", env.corpus_file, "--lines-per-doc", str(env.BL), "--mesh"]
    worlds = ("a world of 1 in process and of 2 processes" if cards == 1
              else f"--mesh alone, a world of {cards}")
    with phase(f"the mesh apps: index --mesh --lines-per-doc {env.BL}, {worlds}"):
        # apps_phase's run of the single-device CLI, else one here.
        out, single_s = getattr(env, "index_single", (None, None))
        if out is None:
            t0 = time.perf_counter()
            out = env.run_cli("mesh_apps_index_single", argv[:-1] + env.cli_extra)
            single_s = time.perf_counter() - t0
            check("mesh_apps_index_single", env.by_path["mesh_apps_index_single"],
                  {"tokenize": rounds(1)})
        idx = {"single_device_cli_s": single_s}
        if out != want:
            raise AssertionError("the single-device index differs from the oracle")
        log(f"  the single-device index CLI: {idx['single_device_cli_s']:.3f} s in process")
        for w in (cards, 2) if cards == 1 else (cards,):
            name = f"mesh_index_w{w}"
            t0 = time.perf_counter()
            if w == cards:
                with _mesh_recorder() as recs:
                    out = env.run_cli(name, argv + env.cli_extra)
                got, ranks_counted = env.by_path[name], 1
            else:
                out, got, _ = world(name, w, argv + env.cli_extra)
                ranks_counted = w
                recs = [r for ln in world.lines for r in ln["mesh"]]
            wall = time.perf_counter() - t0
            # Each rank's drain rounds, summed over the ranks counted.
            drains = sum(r["index_drain_rounds"] for r in recs)
            check(name, got, {"tokenize": rounds(w) * ranks_counted,
                              "partition": rounds(w) * ranks_counted + drains})
            if out != want:
                raise AssertionError(f"{name}: stdout differs from the oracle")
            idx[f"w{w}"] = {"wall_s": wall, "rounds": rounds(w), "drain_rounds": drains,
                            "launches": got}
            log(f"  world of {w}: stdout == oracle == the single-device index ({len(out)} "
                f"bytes), {rounds(w)} rounds, drains {drains}, {wall:.3f} s; launches {got}")
        report["index"] = idx

    # ---- 3. the compiled mesh plan
    with phase("the mesh apps: compile_plan(wordcount_plan(), cfg, mesh=True) in process, "
               "bitonic and hasht"):
        plans = {}
        for mode in ("bitonic", "hasht"):
            name = f"mesh_plan_{mode}"
            cfg = dataclasses.replace(env.cfg, sort_mode=mode)
            t0 = time.perf_counter()
            try:
                with _mesh_recorder() as rec:
                    res, got = counted(lambda: compile_plan(wordcount_plan(), cfg, mesh=True,
                                                            device=dev).run(env.rows))
            finally:
                mesh_mod.shutdown()
            wall = time.perf_counter() - t0
            (r,) = rec
            r1 = rounds(1)
            if mode == "bitonic":
                want_counts = {"tokenize": r1, "bitonic_sort": 2 * r1 + r["drain_rounds"]}
            elif on_card:  # rewritten to fused: kernel C per round
                want_counts = {"fused_fold": r1, "tokenize": r["fused_refolds"]}
            else:  # a CPU rank demotes fused to hasht: the map, no sort
                want_counts = {"tokenize": r1}
            check(name, got, {**want_counts, "partition": r1 + r["drain_rounds"]})
            if res.output != env.want:
                raise AssertionError(f"{name}: the plan's output differs from the CLI's")
            plans[mode] = {"wall_s": wall, "launches": got, **r}
            log(f"  {mode}: output == the CLI's, {r1} rounds, drains {r['drain_rounds']}, "
                f"fused_kernel {r['fused_kernel']}, {wall:.3f} s; launches {got}")
        report["plan"] = plans

    # ---- 4. the sample sort
    n_rows = getattr(env, "sort_rows", SORT_ROWS)
    tokens = []
    for line in env.lines:
        tokens.extend(t for t in _SPLIT.split(line) if t)
        if len(tokens) >= n_rows:
            break
    rows = bytes_ops.strings_to_rows(tokens[:n_rows], 32)
    if rows.shape[0] != n_rows:
        raise AssertionError(f"the corpus has {len(tokens)} tokens, fewer than {n_rows}")
    # Half of the list one word: every rank's share of it lands in one bin.
    dups = bytes_ops.strings_to_rows([b"the"] * (n_rows // 8) + tokens[:n_rows // 8], 32)
    np.save(os.path.join(work, "rows.npy"), rows)
    np.save(os.path.join(work, "dups.npy"), dups)
    cfg32 = EngineConfig(key_width=32)
    with phase(f"the mesh apps: DistributedSort.sort_rows over {rows.shape[0]} token rows and "
               f"sort_strings over {dups.shape[0]} duplicate-heavy strings, worlds of 1 and 2"):
        srt = {}
        t0 = time.perf_counter()
        try:
            out, got = counted(lambda: _sort_checks(
                mesh_mod.make_mesh(device=dev), rows, bytes_ops.rows_to_strings(dups), cfg32,
                DistributedSort, sort_strings, bytes_ops, skew=0.5))
        finally:
            mesh_mod.shutdown()
        srt["w1"] = {"wall_s": time.perf_counter() - t0, "launches": got,
                     **_check_sort("sort_w1", out, rows, dups)}
        # sort_rows once, then each attempt of sort_strings: one partition each.
        check("mesh_sort_w1", got, {"partition": 1 + len(srt["w1"]["attempt_overflows"])})
        t0 = time.perf_counter()
        _, got, _ = world("mesh_sort_w2", 2, [work, "cuda" if on_card else "cpu"],
                          module="chip_smoke:sort_world")
        with np.load(os.path.join(work, "sorted.npz")) as z:
            out = {k: z[k] for k in z.files}
        srt["w2"] = {"wall_s": time.perf_counter() - t0, "launches": got,
                     **_check_sort("sort_w2", out, rows, dups)}
        check("mesh_sort_w2", got, {"partition": 2 * (1 + len(srt["w2"]["attempt_overflows"]))})
        for w in ("w1", "w2"):
            log(f"  world of {w[1]}: {rows.shape[0]} rows sorted == numpy's lexsort, each run's "
                f"values the same multiset; sort_strings: overflows by attempt "
                f"{srt[w]['attempt_overflows']} (one retry), == numpy's order; "
                f"{srt[w]['wall_s']:.3f} s")
        report["sort"] = srt
    report["partition_shapes_checked_in_this_process"] = list(checked)
    if on_card and not checked:
        raise AssertionError("the mesh apps: no partition call on the card was checked")
    log(f"  the partition kernel == its plain version at {len(checked)} shape(s) in this "
        f"process so far: {checked}")
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"  the mesh apps' phase: {report['phase_s']:.1f} s")
    return report


ZIPF_BYTES = 256 << 20


def zipf_phase(env) -> dict:
    """``run_stream`` under fused and bitonic over a seeded Zipf corpus
    (``io/corpus.write_corpus``: seed 0, 30,000 words, exponent 1.1, 10
    words of 7 bytes a line) of ``ZIPF_BYTES``, exact against a Counter
    of the file's words; MB/s, flagged re-folds and peak device memory."""
    from locust_tpu_torch.engine import MapReduceEngine
    from locust_tpu_torch.io.corpus import write_corpus
    from locust_tpu_torch.io.loader import StreamingCorpus

    out = {}
    with phase(f"the Zipf corpus: {ZIPF_BYTES >> 20} MiB (cut from the 1 GiB north star to keep "
               "this script inside its time), run_stream under fused and bitonic"):
        path = os.path.join(env.work, "zipf.txt")
        t0 = time.perf_counter()
        nbytes = write_corpus(path, ZIPF_BYTES, seed=0, n_vocab=30_000, zipf=1.1)
        gen_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            data = f.read()
        n_lines = data.count(b"\n")
        if len(data) != 80 * n_lines:  # 10 words of 7 bytes, 9 spaces, a newline
            raise AssertionError("the Zipf corpus has a line that is not 10 words of 7 bytes")
        want = sorted(collections.Counter(data.split()).items())
        del data
        nblocks = -(-n_lines // env.BL)
        log(f"  write_corpus: {nbytes} bytes, {n_lines} lines, {nblocks} blocks, {len(want)} "
            f"distinct words in {gen_s:.3f} s")
        for mode in ("fused", "bitonic"):
            eng = MapReduceEngine(dataclasses.replace(env.cfg, sort_mode=mode), device=env.dev)
            eng.run_fused(env.rows[: 2 * env.BL])  # warm-up
            if env.dev.type == "cuda":
                env.torch.cuda.reset_peak_memory_stats()
            name = f"zipf_run_stream_{mode}"
            t0 = time.perf_counter()
            res, env.by_path[name] = env.counted(
                lambda: eng.run_stream(StreamingCorpus(path, env.W, env.BL)))
            s = time.perf_counter() - t0
            peak = (env.torch.cuda.max_memory_allocated() / 2**20
                    if env.dev.type == "cuda" else None)
            env.check_pairs(name, res, want)
            if mode == "fused":
                seg = eng._fused_stream_seg
                env.expected[name] = {"tokenize": res.fused_refolds, "bitonic_sort": 0,
                                      "fused_fold": -(-nblocks // seg)}
            else:
                env.expected[name] = {"tokenize": nblocks, "bitonic_sort": nblocks,
                                      "fused_fold": 0}
            out[mode] = {"mb_s": nbytes / s / 1e6, "s": s, "fused_refolds": res.fused_refolds,
                         "peak_device_mib": peak, "blocks": nblocks}
            log(f"  {name}: {len(want)} distinct keys == Counter of the file; {s * 1e3:.3f} ms, "
                f"{nbytes / s / 1e6:.3f} MB/s; flagged re-folds {res.fused_refolds}; peak "
                f"device memory {'not measured' if peak is None else f'{peak:.1f} MiB'}; "
                f"stream {json.dumps(res.stream)}")
        env.check_counts("zipf_run_stream_fused", "zipf_run_stream_bitonic")
        os.remove(path)
    return out


def roofline_rows(env, mode_mbs: dict, stream_mbs: dict, device_kind: str) -> dict:
    """``utils/roofline.summarize`` beside every ``run_fused`` MB/s and
    ``run_stream`` under fused; none may read above 100% of the peak
    (``summarize`` raises)."""
    from locust_tpu_torch.utils import roofline

    rows = {}
    cfg = env.cfg
    for mode, mbs in sorted(mode_mbs.items()):
        rows[f"run_fused_{mode}"] = roofline.summarize(
            mode, cfg.key_lanes, cfg.emits_per_block, cfg.resolved_table_size, env.nblocks,
            env.corpus_bytes / (mbs * 1e6), device_kind, cfg.block_lines, cfg.line_width)
    rows["run_stream_fused"] = roofline.summarize(
        "fused", cfg.key_lanes, cfg.emits_per_block, cfg.resolved_table_size, env.nblocks,
        env.corpus_bytes / (stream_mbs["fused"] * 1e6), device_kind, cfg.block_lines,
        cfg.line_width, fused_variant="stream")
    for name, r in rows.items():
        if r["hbm_utilization_pct"] is not None and r["hbm_utilization_pct"] > 100:
            raise AssertionError(f"{name}: {r['hbm_utilization_pct']}% of the peak")
        log(f"  roofline {name}: least bytes {r['min_bytes']} at {r['achieved_min_gb_s']} GB/s = "
            f"{r['hbm_utilization_pct']}% of {r['hbm_peak_gb_s']} GB/s; the TPU model's sort "
            f"traffic {r['est_sort_traffic_gb']} GB ({r['sort_passes']} passes, "
            f"{r['achieved_sort_gb_s']} GB/s on it)")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "locust_tpu_torch")):
        raise SystemExit("chip_smoke: the locust_tpu_torch package is not beside this script")
    sys.path.insert(0, HERE)
    from locust_tpu_torch import _build, cli
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.core import bytes_ops
    from locust_tpu_torch.core.kv import KVBatch
    from locust_tpu_torch.core.packing import pack_keys
    from locust_tpu_torch.engine import MapReduceEngine, finalize_host_pairs
    from locust_tpu_torch.io import serde
    from locust_tpu_torch.io.loader import StreamingCorpus
    from locust_tpu_torch.state import load_jax_checkpoint
    from locust_tpu_torch.utils import roofline
    from locust_tpu_torch.ops.kernels.fused_fold import (
        fused_block_preagg,
        fused_preagg_reference,
    )
    from locust_tpu_torch.apps.inverted_index import default_pairs_capacity
    from locust_tpu_torch.config import BITONIC_TILE_BITS
    from locust_tpu_torch.ops.kernels.sort import (
        bitonic_network_reference,
        bitonic_reference,
        bitonic_sort_rows,
        plan_steps,
        padded_size,
    )
    from locust_tpu_torch.ops.kernels.tokenize import (
        tokenize_block_kernel,
        tokenize_reference,
    )

    dev = torch.device("cuda")

    with phase("machine"):
        log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
        nvcc = _build.nvcc_path()
        log(f"nvcc {nvcc}: {_run([nvcc, '--version']).splitlines()[-1]}")
        try:
            import triton

            log(f"triton {triton.__version__}")
        except ImportError:
            log("triton not importable")
        smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
        log(f"nvidia-smi: {smi}")
        log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    with phase("static analysis: python -m locust_tpu_torch.analysis"):
        analysis_phase()

    with phase("build kernels (nvcc) and the native reader (g++)"):
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            host = pool.submit(_build.build_host)
            reports = _build.build()
            host.result()
        log(f"built {sorted(reports)} and {list(_build.HOST_SOURCES)} "
            f"({_build.library_path('ingest').name}) in {time.perf_counter() - t0:.2f} s")
        for name, report in sorted(reports.items()):
            for line in report.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"  {name}: {line.strip()}")

    cfg = EngineConfig(sort_mode="bitonic", use_pallas=True)  # the CLI's defaults
    E, K, W, BL = cfg.emits_per_line, cfg.key_width, cfg.line_width, cfg.block_lines
    lines, corpus_bytes = replicated_corpus(TARGET_BYTES)
    rows = bytes_ops.strings_to_rows(lines, W)

    with phase("kernel A (tokenizer) against its plain version"):
        rng = np.random.default_rng(0)
        alphabet = np.frombuffer(b"abcdefghij  ,.-\x00\r\n'\"()\t;:QZ\xe9", np.uint8)
        fuzz = alphabet[rng.integers(0, len(alphabet), (BL, W))]
        fuzz[rng.random(BL) < 0.2, 40:100] = ord("w")  # tokens longer than K
        fuzz[rng.random(BL) < 0.1] = ord("x")          # one token filling the row
        # Rows the bit masks must get right: no delimiter, delimiters only,
        # tokens across 16-byte boundaries, bytes >= 0x80, a token up to
        # the row end.
        special = np.resize(np.frombuffer(b"o nmlkjihgfedcba", np.uint8), (BL, W))
        special[0::5] = ord("x")
        special[1::5] = ord(" ")
        special[2::5] = np.resize(np.frombuffer(b"\xc3\xa9t\xe9 \x80\x81\xff.", np.uint8), W)
        special[3::5, :W - 7] = ord(",")
        # (name, block, E, K): the main path's shape, then other widths
        # (below 16 and not multiples of 16: unaligned lines), E and K.
        cases = [("fuzz", fuzz, E, K), ("corpus", rows[:BL], E, K),
                 ("corpus_tail", rows[-BL:], E, K), ("special rows", special, E, K),
                 ("corpus, a run_stream segment (a flagged segment's re-fold)", rows[:8 * BL], E, K)]
        for w in (1, 15, 33, 100, 129, 2048):
            wide = alphabet[rng.integers(0, len(alphabet), (1024, w))]
            wide[rng.random(1024) < 0.2, w // 3:w // 3 + 40] = ord("w")
            cases.append((f"fuzz W={w}", wide, E, K))
        cases += [("fuzz E=1", fuzz, 1, K), ("fuzz E=256", fuzz[:1024], 256, K),
                  ("fuzz K=4", fuzz, E, 4), ("fuzz K=64", fuzz, E, 64)]
        err_a = 0
        for name, blk, e_, k_ in cases:
            x = torch.from_numpy(np.ascontiguousarray(blk)).to(dev)
            keys, valid, ovf = tokenize_block_kernel(x, e_, k_)
            rkeys, rvalid, rovf = tokenize_reference(x, e_, k_)
            torch.cuda.synchronize()
            err = max(
                int((keys.int() - rkeys.int()).abs().max()),
                int((valid.int() - rvalid.int()).abs().max()),
                abs(int(ovf) - int(rovf)),
            )
            if err:
                raise AssertionError(f"tokenizer kernel differs from plain on {name}: max abs err {err}")
            err_a = max(err_a, err)
            log(f"  {name} {list(blk.shape)} E={e_} K={k_}: exact, {int(valid.sum())} tokens, "
                f"overflow {int(ovf)}")

    with phase("kernel B (bitonic sort) against the network reference, bit for bit"):
        # Keys and payload rows in order must equal Batcher's network run
        # as torch ops (the TPU kernel's permutation); where no real key
        # is 0xFFFFFFFF the rows must also be the input rows, moved.
        tile = 1 << BITONIC_TILE_BITS
        cases = [(n, kind, 9) for n in (1, 1000, 1024, 81920, 131072, 147456, 262144, 1 << 20)
                 for kind in ("dups", "equal")]
        cases += [(5000, "sentinel", 9), (147456, "sentinel", 9), (147456, "dups", 0),
                  (tile + 1, "dups", 9), (tile + 1, "equal", 0),
                  # The tf fold's shape: the pair table plus a block, 10 payloads.
                  (245760, "dups", 10), (245760, "sentinel", 10),
                  # The mesh's merge and the hierarchical combine at the CLI
                  # defaults: a 163,840-row shard plus as many received rows
                  # (or a second slice's shard), padded to 2^19.
                  (327680, "dups", 9), (327680, "equal", 9), (327680, "sentinel", 9)]
        err_b = 0
        for n, kind, width in cases:
            g = torch.Generator(device=dev).manual_seed(n)
            if kind == "equal":
                key = torch.full((n,), 0x12345678, dtype=torch.int32, device=dev)
            else:  # duplicate-heavy, the high bit set on half the keys
                pool = torch.randint(-(2**31), 2**31 - 1, (max(n // 8, 1),), generator=g,
                                     device=dev, dtype=torch.int64).to(torch.int32)
                if kind == "sentinel":  # real keys equal to the pad's 0xFFFFFFFF
                    pool[::3] = -1
                key = pool[torch.randint(0, pool.numel(), (n,), generator=g, device=dev)]
            pay = torch.randint(-(2**31), 2**31 - 1, (n, width), generator=g, device=dev,
                                dtype=torch.int64).to(torch.int32)
            if width:
                pay[:, 0] = torch.arange(n, device=dev, dtype=torch.int32)
            sk, sp = bitonic_sort_rows(key, pay)
            rk, rp = bitonic_network_reference(key, pay)
            torch.cuda.synchronize()
            err = max(int((sk.to(torch.int64) - rk.to(torch.int64)).abs().max()),
                      int((sp.to(torch.int64) - rp.to(torch.int64)).abs().max()) if width else 0)
            if err or not (torch.equal(sk, rk) and torch.equal(sp, rp)):
                raise AssertionError(f"bitonic kernel differs from the network reference at "
                                     f"n={n} ({kind}, width {width}): max abs err {err}")
            if kind != "sentinel" and width:
                perm = sp[:, 0].long()
                if not (torch.equal(torch.sort(perm).values, torch.arange(n, device=dev))
                        and torch.equal(sp, pay[perm]) and torch.equal(key[perm], sk)
                        and torch.equal(sk, bitonic_reference(key, pay)[0])):
                    raise AssertionError(f"bitonic kernel rows inconsistent at n={n} ({kind})")
            pads = int((sp == 0).all(dim=1).sum()) if kind == "sentinel" else 0
            err_b = max(err_b, err)
            log(f"  n={n} (pad {padded_size(n)}, {plan_steps(n)} plan steps in "
                f"{bitonic_sort_rows.cuda_launches} CUDA launches), {kind}, "
                f"{width} payloads: keys and rows equal the network reference"
                + (f" ({pads} pad rows among the first n)" if kind == "sentinel" else ""))

    cfg_f = EngineConfig(sort_mode="fused", use_pallas=True)
    with phase("kernel C (fused pre-aggregation) against its plain version"):
        # Per case: the union of table and residual rows with duplicate
        # keys re-merged, the overflow and the flag must equal the plain
        # version's; where the flag is set the rows are discarded by the
        # engine and only the flag and overflow count.
        rng = np.random.default_rng(1)
        alphabet = np.frombuffer(b"abc  ,.-\x00\r\n'\"()\t;:QZ\xe9", np.uint8)
        fuzz_c = alphabet[rng.integers(0, len(alphabet), (BL, W))]
        fuzz_c[rng.random(BL) < 0.2, 40:100] = ord("w")  # tokens longer than K
        fuzz_c[rng.random(BL) < 0.1] = ord("x")          # one token filling the row
        wide = bytes_ops.strings_to_rows(
            [a + b" " + b for a, b in zip(lines[:BL // 2], lines[BL // 2:BL])], 2 * W)
        cases = [
            ("fuzz", fuzz_c, cfg_f, {}, False),
            ("corpus", rows[:BL], cfg_f, {}, False),
            ("corpus_tail", rows[-BL:], cfg_f, {}, False),
            # 64 table slots strand most keys; 1,024 residual rows per tile
            # hold all of a tile's <= 640 emits, so the flag stays clear.
            ("corpus, stranding", rows[:BL], cfg_f, {"table_slots": 64, "resid_rows": 1024}, False),
            # Every tile of kernel A's fuzz has far more than 64 + 32
            # distinct keys: the flag is set in any order of insertion.
            ("fuzz A, overflow", fuzz, cfg_f, {"table_slots": 64, "resid_rows": 32}, True),
            # Other shapes the kernel takes: wider lines, narrower keys and
            # 64-line tiles; 64-byte keys and 40 emits (above 48 KB of
            # shared memory); 128-line tiles with one probe.
            ("corpus, width 256", wide, EngineConfig(
                sort_mode="fused", line_width=2 * W, key_width=16, emits_per_line=8),
             {"tile_lines": 64, "probes": 2}, False),
            ("fuzz, K=64 E=40", fuzz_c, EngineConfig(
                sort_mode="fused", key_width=64, emits_per_line=40), {}, False),
            ("corpus, 128-line tiles, 1 probe", rows[:BL], cfg_f,
             {"tile_lines": 128, "probes": 1, "resid_rows": 1024}, False),
            # 16 blocks' lines in one call: 2,048 tiles, more than the
            # blocks that fit on the card at once, so each block takes
            # several tiles; and a single tile.
            ("corpus, a run_stream segment (8 blocks, 1,024 tiles)", rows[:8 * BL], cfg_f, {}, False),
            ("corpus, 16 blocks (2,048 tiles)", rows[:16 * BL], cfg_f, {}, False),
            ("corpus, one tile", rows[BL:BL + 32], cfg_f, {}, False),
        ]
        err_c = 0
        for name, blk, ccfg, kw, want_flag in cases:
            x = torch.from_numpy(np.ascontiguousarray(blk)).to(dev)
            tab, res, ovf, flag = fused_block_preagg(x, ccfg, **kw)
            rtab, rres, rovf, rflag = fused_preagg_reference(x, ccfg, **kw)
            torch.cuda.synchronize()
            got = dict(finalize_host_pairs(KVBatch.concat(tab, res)))
            plain = dict(finalize_host_pairs(KVBatch.concat(rtab, rres)))
            # The kernel writes every row: valid is count > 0, and a row
            # that is not valid is zero.
            for part in (tab, res):
                if not (torch.equal(part.valid, part.values > 0)
                        and not part.key_lanes[~part.valid].any()):
                    raise AssertionError(f"fused kernel on {name}: a row's valid byte or "
                                         "its zeros are wrong")
            err = max(abs(int(ovf) - int(rovf)), abs(int(flag) - int(rflag)))
            if not want_flag:
                err = max([err] + [abs(got.get(k, 0) - plain.get(k, 0)) for k in got.keys() | plain.keys()])
            if err or bool(flag) != want_flag:
                raise AssertionError(f"fused kernel differs from plain on {name}: max abs err {err}, "
                                     f"flag {bool(flag)} (plain {bool(rflag)}, expected {want_flag})")
            err_c = max(err_c, err)
            log(f"  {name} {list(blk.shape)} E={ccfg.emits_per_line} K={ccfg.key_width} "
                f"{kw or 'defaults'}: "
                f"{'flag set, as expected' if want_flag else f'{len(got)} distinct keys exact'}, "
                f"table rows {int(tab.valid.sum())}, residual rows {int(res.valid.sum())}, "
                f"overflow {int(ovf)}")

    with phase("main path: run_fused, timed_run and the CLI, WordCount over the replicated corpus"):
        log(f"  corpus: {len(lines)} lines, {corpus_bytes} bytes ({corpus_bytes / 2**20:.2f} MiB), "
            f"cfg block_lines={BL} line_width={W} key_width={K} emits={E} "
            f"table={cfg.resolved_table_size} sort_mode={cfg.sort_mode} use_pallas={cfg.use_pallas}")
        oracle = sorted(oracle_wordcount(lines, W, E, K).items())
        nblocks = -(-len(lines) // BL)
        eng = MapReduceEngine(cfg)  # device None: CUDA
        eng.run_fused(rows[: 2 * BL])  # first-call warm-up, outside the counted windows
        torch.cuda.synchronize()

        # Each path's exact count: one tokenizer launch per block; one
        # sort per block for the fold, two (Process + table merge) for
        # the staged run, which the CLI's default stage report runs.
        expected = _Expected({
            "run_fused": {"tokenize": nblocks, "bitonic_sort": nblocks, "fused_fold": 0},
            "timed_run": {"tokenize": nblocks, "bitonic_sort": 2 * nblocks, "fused_fold": 0},
            "cli": {"tokenize": nblocks, "bitonic_sort": 2 * nblocks, "fused_fold": 0},
        })
        by_path = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fused, by_path["run_fused"] = counted(lambda: eng.run_fused(rows))
        fused_s = time.perf_counter() - t0
        timed, by_path["timed_run"] = counted(lambda: eng.timed_run(rows))
        peak_mib = torch.cuda.max_memory_allocated() / 2**20

        # The CLI, as a user calls it, over the same corpus written to a file.
        with tempfile.TemporaryDirectory() as tmp:
            corpus_file = os.path.join(tmp, "corpus.txt")
            with open(corpus_file, "wb") as f:
                f.write(b"\n".join(lines) + b"\n")
            out = io.BytesIO()
            cli_stdout = io.TextIOWrapper(out, write_through=True)
            with contextlib.redirect_stdout(cli_stdout):
                rc, by_path["cli"] = counted(lambda: cli.main([corpus_file]))
            cli_bytes = out.getvalue()

        for name, res in (("run_fused", fused), ("timed_run", timed)):
            pairs = res.to_host_pairs()
            if pairs != oracle or res.truncated:
                raise AssertionError(f"{name}: host pairs differ from the oracle "
                                     f"({len(pairs)} vs {len(oracle)} keys)")
            log(f"  {name}: {len(pairs)} distinct keys == oracle, overflow {res.overflow_tokens}")
        want = b"".join(k + b"\t" + str(v).encode() + b"\n" for k, v in oracle)
        if rc != 0 or cli_bytes != want:
            raise AssertionError("CLI stdout differs from the oracle on the replicated corpus")
        log(f"  CLI (python -m locust_tpu_torch FILE, {corpus_bytes} bytes): stdout == oracle")
        for name, got in by_path.items():
            log(f"  launches in {name} over {nblocks} blocks: {got}, expected {expected[name]}")
            if got != expected[name]:
                raise AssertionError(f"{name} did not launch each kernel as its path must: "
                                     f"{got} != {expected[name]}")
        repeat_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.run_fused(rows)
            torch.cuda.synchronize()
            repeat_s.append(time.perf_counter() - t0)
        log(f"  run_fused: {fused_s * 1e3:.3f} ms, {corpus_bytes / fused_s / 1e6:.3f} MB/s")
        med = float(np.median(repeat_s))
        log(f"  run_fused, {len(repeat_s)} more runs: median {med * 1e3:.3f} ms, "
            f"{corpus_bytes / med / 1e6:.3f} MB/s; runs ms {[round(s * 1e3, 3) for s in repeat_s]}")
        t = timed.times
        log(f"  timed_run: Map {t.map_ms:.3f} ms, Process {t.process_ms:.3f} ms, "
            f"Reduce {t.reduce_ms:.3f} ms, {corpus_bytes / (t.total_ms / 1e3) / 1e6:.3f} MB/s "
            f"over the stage total")
        log(f"  peak device memory (run_fused + timed_run): {peak_mib:.1f} MiB")

    with phase("main path under sort_mode fused, hasht and hasht-mxu: run_fused and the CLI"):
        # "fused": one fused-kernel launch per block, no sort; the
        # tokenizer runs only in the stock re-fold of a flagged block.
        # "hasht"/"hasht-mxu": the tokenizer per block, the hash-table fold.
        engines = {mode: MapReduceEngine(EngineConfig(sort_mode=mode, use_pallas=True))
                   for mode in ("fused", "hasht", "hasht-mxu")}
        for e in engines.values():
            e.run_fused(rows[: 2 * BL])  # first-call warm-up
        results = {}
        for mode, e in engines.items():
            key = "run_fused_" + mode.replace("-", "_")
            results[key], by_path[key] = counted(lambda: e.run_fused(rows))
            expected[key] = ({"tokenize": 0, "bitonic_sort": 0, "fused_fold": nblocks}
                             if mode == "fused" else
                             {"tokenize": nblocks, "bitonic_sort": 0, "fused_fold": 0})
        refolds = results["run_fused_fused"].fused_refolds
        expected["run_fused_fused"]["tokenize"] = refolds
        with tempfile.TemporaryDirectory() as tmp:
            corpus_file = os.path.join(tmp, "corpus.txt")
            with open(corpus_file, "wb") as f:
                f.write(b"\n".join(lines) + b"\n")
            out = io.BytesIO()
            cli_stdout = io.TextIOWrapper(out, write_through=True)
            with contextlib.redirect_stdout(cli_stdout):
                rc, by_path["cli_fused"] = counted(
                    lambda: cli.main([corpus_file, "--sort-mode", "fused", "--no-timing"]))
            cli_bytes = out.getvalue()
        expected["cli_fused"] = {"tokenize": 0, "bitonic_sort": 0, "fused_fold": nblocks}
        for name, res in results.items():
            pairs = res.to_host_pairs()
            if pairs != oracle or res.truncated:
                raise AssertionError(f"{name}: host pairs differ from the oracle "
                                     f"({len(pairs)} vs {len(oracle)} keys)")
            log(f"  {name}: {len(pairs)} distinct keys == oracle, overflow {res.overflow_tokens}, "
                f"fused_kernel {res.fused_kernel}, flagged re-folds {res.fused_refolds}")
        if refolds != 0 or results["run_fused_fused"].fused_kernel != "batch":
            raise AssertionError(f"run_fused under fused: {refolds} flagged re-folds, expected 0")
        if rc != 0 or cli_bytes != want:
            raise AssertionError("CLI --sort-mode fused stdout differs from the oracle")
        log(f"  CLI (--sort-mode fused --no-timing, {corpus_bytes} bytes): stdout == oracle")

        # A vocabulary past the kernel table: 40,000 seeded words, 10 per
        # line, give each 4,096-line block about 25,000 distinct keys for
        # the 8,192-slot kernel table, so its tiles strand more keys than
        # their 32 residual rows hold.  Such blocks take the flagged
        # re-fold: map_fn through the tokenizer kernel, then the hasht fold.
        vrng = np.random.default_rng(2)
        letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
        vocab = [letters[vrng.integers(0, 26, n)].tobytes() for n in vrng.integers(3, 11, 40_000)]
        vlines = [b" ".join(vocab[j] for j in ids)
                  for ids in vrng.integers(0, len(vocab), (8 * BL, 10))]
        vrows = bytes_ops.strings_to_rows(vlines, W)
        t0 = time.perf_counter()
        vres, by_path["run_fused_fused_vocab"] = counted(lambda: engines["fused"].run_fused(vrows))
        v_s = time.perf_counter() - t0
        vblocks = -(-len(vlines) // BL)
        expected["run_fused_fused_vocab"] = {
            "tokenize": vres.fused_refolds, "bitonic_sort": 0, "fused_fold": vblocks}
        voracle = sorted(oracle_wordcount(vlines, W, E, K).items())
        vpairs = vres.to_host_pairs()
        if vpairs != voracle or vres.truncated:
            raise AssertionError(f"run_fused under fused, large vocabulary: host pairs differ "
                                 f"from the oracle ({len(vpairs)} vs {len(voracle)} keys)")
        if vres.fused_refolds == 0:
            raise AssertionError("run_fused under fused, large vocabulary: no block was "
                                 "flagged, the re-fold branch did not run")
        log(f"  run_fused_fused_vocab ({len(vlines)} lines, {vrows.nbytes} bytes of rows, "
            f"{vblocks} blocks): {len(vpairs)} distinct keys == oracle, flagged re-folds "
            f"{vres.fused_refolds} of {vblocks} blocks, {v_s * 1e3:.3f} ms")
        for name in ("run_fused_fused", "cli_fused", "run_fused_hasht", "run_fused_hasht_mxu",
                     "run_fused_fused_vocab"):
            got = by_path[name]
            n = vblocks if name == "run_fused_fused_vocab" else nblocks
            log(f"  launches in {name} over {n} blocks: {got}, expected {expected[name]}")
            if got != expected[name]:
                raise AssertionError(f"{name} did not launch each kernel as its path must: "
                                     f"{got} != {expected[name]}")
        mode_mbs = {"bitonic": corpus_bytes / med / 1e6}
        for mode in ("fused", "hasht"):
            runs = []
            for _ in range(5):
                t0 = time.perf_counter()
                engines[mode].run_fused(rows)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            m = float(np.median(runs))
            mode_mbs[mode] = corpus_bytes / m / 1e6
            log(f"  run_fused under {mode}, 5 runs: median {m * 1e3:.3f} ms, "
                f"{mode_mbs[mode]:.3f} MB/s; runs ms {[round(r * 1e3, 3) for r in runs]}")
        log(f"  run_fused MB/s (medians of 5): {json.dumps(mode_mbs)}")

    # ---- the rest of the single-device job: the torch.sort modes, the
    # streaming, resumable and batched runners, and the staged CLI, all
    # over the corpus file in a temporary directory.
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    corpus_file = os.path.join(work.name, "corpus.txt")
    with open(corpus_file, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")

    def check_pairs(name, res, want_pairs):
        pairs = res.to_host_pairs()
        if pairs != want_pairs or res.truncated:
            raise AssertionError(f"{name}: host pairs differ from the oracle "
                                 f"({len(pairs)} vs {len(want_pairs)} keys)")

    check_counts = functools.partial(check_launches, by_path, expected)
    run_cli = functools.partial(run_cli_counted, by_path)

    def median_s(fn, n=3):
        runs = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        return float(np.median(runs)), runs

    def stream_of_corpus(use_native=True):
        return StreamingCorpus(corpus_file, W, BL, use_native=use_native)

    with phase("the torch.sort modes through run_fused over the replicated corpus"):
        sort_modes = ("lex", "hash", "hashp", "hashp2", "hash1", "radix")
        for mode in sort_modes:
            e = MapReduceEngine(EngineConfig(sort_mode=mode, use_pallas=True))
            e.run_fused(rows[: 2 * BL])  # first-call warm-up
            torch.cuda.synchronize()
            key = f"run_fused_{mode}"
            res, by_path[key] = counted(lambda: e.run_fused(rows))
            expected[key] = {"tokenize": nblocks, "bitonic_sort": 0, "fused_fold": 0}
            check_pairs(key, res, oracle)
            m, runs = median_s(lambda: e.run_fused(rows))
            mode_mbs[mode] = corpus_bytes / m / 1e6
            log(f"  {key}: {res.num_segments} distinct keys == oracle; 3 runs median "
                f"{m * 1e3:.3f} ms, {mode_mbs[mode]:.3f} MB/s; runs ms "
                f"{[round(r * 1e3, 3) for r in runs]}")
            del e
        check_counts(*(f"run_fused_{m}" for m in sort_modes))
        log(f"  run_fused MB/s by mode: {json.dumps(mode_mbs)}")

    fe = engines["fused"]
    seg = fe._fused_stream_seg
    nseg = -(-nblocks // seg)
    stream_mbs = {}
    native_reader_phase(types.SimpleNamespace(corpus_file=corpus_file, W=W, BL=BL, rows=rows,
                                              corpus_bytes=corpus_bytes, median_s=median_s))
    with phase("run_stream over a StreamingCorpus of the corpus file (the native reader): "
               "fused, then bitonic"):
        sres, by_path["run_stream_fused"] = counted(lambda: fe.run_stream(stream_of_corpus()))
        check_pairs("run_stream_fused", sres, oracle)
        fs = sres.stream["fused"]
        log(f"  run_stream_fused: {sres.num_segments} distinct keys == oracle, fused_kernel "
            f"{sres.fused_kernel}, stream {json.dumps(sres.stream)}")
        if (sres.fused_kernel != "stream" or fs["segments"] != nseg or seg != 8
                or fs["interpret"] or sres.fused_refolds):
            raise AssertionError(f"run_stream under fused: expected {nseg} segments of 8 blocks "
                                 f"through the kernel and no re-fold, got {fs}, "
                                 f"{sres.fused_refolds} re-folds")
        expected["run_stream_fused"] = {"tokenize": 0, "bitonic_sort": 0, "fused_fold": nseg}
        # The 40,000-word vocabulary (8 blocks): one segment, flagged, so
        # the whole segment is folded again through the tokenizer and the
        # hasht fold (655,360 emits at once).
        torch.cuda.reset_peak_memory_stats()
        vsres, by_path["run_stream_fused_vocab"] = counted(
            lambda: fe.run_stream(iter([vrows[i:i + BL] for i in range(0, len(vrows), BL)])))
        check_pairs("run_stream_fused_vocab", vsres, voracle)
        expected["run_stream_fused_vocab"] = {"tokenize": 1, "bitonic_sort": 0, "fused_fold": 1}
        if vsres.fused_refolds != 1 or vsres.stream["fused"]["segments"] != 1:
            raise AssertionError(f"run_stream under fused, large vocabulary: "
                                 f"{vsres.fused_refolds} re-folds of {vsres.stream['fused']}")
        log(f"  run_stream_fused_vocab: {len(vpairs)} distinct keys == oracle, 1 segment "
            f"flagged and re-folded; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        bres, by_path["run_stream_bitonic"] = counted(lambda: eng.run_stream(stream_of_corpus()))
        check_pairs("run_stream_bitonic", bres, oracle)
        expected["run_stream_bitonic"] = {"tokenize": nblocks, "bitonic_sort": nblocks,
                                          "fused_fold": 0}
        log(f"  run_stream_bitonic: {bres.num_segments} distinct keys == oracle, stream "
            f"{json.dumps(bres.stream)}")
        check_counts("run_stream_fused", "run_stream_fused_vocab", "run_stream_bitonic")
        for mode, e in (("fused", fe), ("bitonic", eng)):
            m, runs = median_s(lambda: e.run_stream(stream_of_corpus()))
            stream_mbs[mode] = corpus_bytes / m / 1e6
            log(f"  run_stream under {mode}, 3 runs: median {m * 1e3:.3f} ms, "
                f"{stream_mbs[mode]:.3f} MB/s; runs ms {[round(r * 1e3, 3) for r in runs]}")
        # The same runs through the Python reader (use_native=False).
        for mode, e in (("fused", fe), ("bitonic", eng)):
            m, runs = median_s(lambda: e.run_stream(stream_of_corpus(use_native=False)))
            stream_mbs[f"{mode}_python_reader"] = corpus_bytes / m / 1e6
            log(f"  run_stream under {mode} through the Python reader, 3 runs: median "
                f"{m * 1e3:.3f} ms, {stream_mbs[f'{mode}_python_reader']:.3f} MB/s")
        # What the stream is waiting for: the host reader alone (native,
        # then Python), and the fold loop over blocks read beforehand.
        m, runs = median_s(lambda: sum(1 for _ in stream_of_corpus()))
        stream_mbs["reader_alone"] = corpus_bytes / m / 1e6
        m, runs = median_s(lambda: sum(1 for _ in stream_of_corpus(use_native=False)))
        stream_mbs["reader_alone_python"] = corpus_bytes / m / 1e6
        held = list(stream_of_corpus())
        for mode, e in (("fused", fe), ("bitonic", eng)):
            m, runs = median_s(lambda: e.run_stream(iter(held)))
            stream_mbs[f"{mode}_blocks_in_memory"] = corpus_bytes / m / 1e6
        del held
        log(f"  run_stream MB/s (medians of 3; the reader alone, and run_stream over blocks "
            f"read beforehand): {json.dumps(stream_mbs)}")

    class Stop(RuntimeError):
        """The injected crash."""

    def dying(blocks, after):
        for i, blk in enumerate(blocks):
            if i == after:
                raise Stop(f"stopped before block {after}")
            yield blk

    with phase("crash and resume: run_stream (bitonic, fused) and run_checkpointed, "
               "stopped after block 50"):
        fp = stream_of_corpus().fingerprint()
        for mode, e in (("bitonic", eng), ("fused", fe)):
            ckpt = os.path.join(work.name, f"stream_{mode}")
            try:
                e.run_stream(dying(stream_of_corpus(), 50), checkpoint_dir=ckpt, every=8,
                             fingerprint=fp)
            except Stop:
                pass
            else:
                raise AssertionError("the dying iterator did not stop run_stream")
            start = load_jax_checkpoint(os.path.join(ckpt, "state.npz"), "cpu").next_block
            name = f"run_stream_{mode}_resumed"
            res, by_path[name] = counted(lambda: e.run_stream(
                stream_of_corpus(), checkpoint_dir=ckpt, every=8, fingerprint=fp))
            check_pairs(name, res, oracle)
            rest = nblocks - start
            expected[name] = ({"tokenize": rest, "bitonic_sort": rest, "fused_fold": 0}
                              if mode == "bitonic" else
                              {"tokenize": 0, "bitonic_sort": 0, "fused_fold": -(-rest // seg)})
            if start != 48 or res.stream["blocks"] != rest:
                raise AssertionError(f"{name}: snapshot at block {start} (expected 48), "
                                     f"{res.stream['blocks']} blocks folded (expected {rest})")
            log(f"  {name}: snapshot at block {start}, {rest} blocks folded after it, "
                f"pairs == oracle, checkpoint {json.dumps(res.stream['ckpt'])}")
        ckpt = os.path.join(work.name, "checkpointed")
        real_fold, folds = eng.fold_block, [0]

        def dying_fold(acc, blk):
            if folds[0] == 50:
                raise Stop("stopped before block 50")
            folds[0] += 1
            return real_fold(acc, blk)

        eng.fold_block = dying_fold
        try:
            eng.run_checkpointed(rows, ckpt, every=8)
        except Stop:
            pass
        else:
            raise AssertionError("the dying fold did not stop run_checkpointed")
        finally:
            del eng.fold_block  # the class's method again
        start = load_jax_checkpoint(os.path.join(ckpt, "state.npz"), "cpu").next_block
        res, by_path["run_checkpointed_resumed"] = counted(
            lambda: eng.run_checkpointed(rows, ckpt, every=8))
        check_pairs("run_checkpointed_resumed", res, oracle)
        rest = nblocks - start
        expected["run_checkpointed_resumed"] = {"tokenize": rest, "bitonic_sort": rest,
                                                "fused_fold": 0}
        if start != 48:
            raise AssertionError(f"run_checkpointed: snapshot at block {start}, expected 48")
        log(f"  run_checkpointed_resumed: snapshot at block {start}, {rest} blocks folded "
            "after it, pairs == oracle")
        check_counts("run_stream_bitonic_resumed", "run_stream_fused_resumed",
                     "run_checkpointed_resumed")

    with phase("run_batch: three jobs (two slices of the corpus, one zero job)"):
        jb = 20
        stack = np.zeros((3, jb, BL, W), np.uint8)
        for j in range(2):
            stack[j] = rows[j * jb * BL:(j + 1) * jb * BL].reshape(jb, BL, W)
        jobs, by_path["run_batch"] = counted(lambda: eng.run_batch(stack))
        expected["run_batch"] = {"tokenize": 3 * jb, "bitonic_sort": 3 * jb, "fused_fold": 0}
        for j in range(2):
            part = lines[j * jb * BL:(j + 1) * jb * BL]
            check_pairs(f"run_batch job {j}", jobs[j], sorted(oracle_wordcount(part, W, E, K).items()))
            if jobs[j].to_host_pairs() != eng.run_fused(rows[j * jb * BL:(j + 1) * jb * BL]).to_host_pairs():
                raise AssertionError(f"run_batch job {j} differs from run_fused of its slice")
        if jobs[2].num_segments or bool(jobs[2].table.valid.any()):
            raise AssertionError("run_batch: the zero job's table is not empty")
        log(f"  run_batch: jobs of {jb} blocks: {jobs[0].num_segments} and "
            f"{jobs[1].num_segments} distinct keys == oracle and == run_fused of their "
            "slices; the zero job's table is empty")
        check_counts("run_batch")

    with phase("the staged CLI: stage 1 on two line ranges (tsv, bin), stage 2 on both; "
               "--stream --checkpoint-dir under fused; --auto-caps"):
        half = len(lines) // 2
        n1, n2 = -(-half // BL), -(-(len(lines) - half) // BL)
        part_t = os.path.join(work.name, "node0.tsv")
        part_b = os.path.join(work.name, "node1.bin")
        out1 = run_cli("cli_stage1_tsv", [corpus_file, "0", str(half), "0", "1", "-i", part_t,
                                          "--inter-format", "tsv"])
        out2 = run_cli("cli_stage1_bin", [corpus_file, str(half), "-1", "1", "1", "-i", part_b,
                                          "--inter-format", "bin"])
        out3 = run_cli("cli_stage2", [corpus_file, "0", "0", "2", "2", "-i", part_t, "-i", part_b])
        expected["cli_stage1_tsv"] = {"tokenize": n1, "bitonic_sort": 2 * n1, "fused_fold": 0}
        expected["cli_stage1_bin"] = {"tokenize": n2, "bitonic_sort": 2 * n2, "fused_fold": 0}
        expected["cli_stage2"] = {"tokenize": 0, "bitonic_sort": 1, "fused_fold": 0}
        half_oracle = sorted(oracle_wordcount(lines[:half], W, E, K).items())
        with open(part_t, "rb") as f:
            if f.read() != b"".join(k + b"\t" + str(v).encode() + b"\n" for k, v in half_oracle):
                raise AssertionError("stage 1: the tsv intermediate differs from the oracle")
        keys_b, values_b = serde.read_intermediate(part_b, K)
        if len(values_b) != len(oracle_wordcount(lines[half:], W, E, K)):
            raise AssertionError("stage 1: the bin intermediate has the wrong number of pairs")
        if out1 or out2 or out3 != want:
            raise AssertionError("the staged CLI's stdout differs from the oracle")
        log(f"  stage 1 over [0, {half}) ({n1} blocks, tsv) and [{half}, end) ({n2} blocks, "
            f"bin), stage 2 over both ({len(half_oracle) + len(values_b)} pairs): stdout == oracle")
        log(f"  read_tsv of the stage-1 tsv ({read_tsv_check(part_t, K)} pairs): "
            "native == Python")
        out4 = run_cli("cli_stream_fused_ckpt", [
            corpus_file, "--stream", "--checkpoint-dir", os.path.join(work.name, "cli_ckpt"),
            "--sort-mode", "fused", "--no-timing"])
        expected["cli_stream_fused_ckpt"] = {"tokenize": 0, "bitonic_sort": 0, "fused_fold": nseg}
        out5 = run_cli("cli_auto_caps", [corpus_file, "--auto-caps"])
        expected["cli_auto_caps"] = {"tokenize": nblocks, "bitonic_sort": 2 * nblocks,
                                     "fused_fold": 0}
        if out4 != want or out5 != want:
            raise AssertionError("CLI --stream --checkpoint-dir or --auto-caps stdout differs "
                                 "from the oracle")
        log("  --stream --checkpoint-dir --sort-mode fused --no-timing and --auto-caps: "
            "stdout == oracle")
        check_counts("cli_stage1_tsv", "cli_stage1_bin", "cli_stage2", "cli_stream_fused_ckpt",
                     "cli_auto_caps")

    # ---- the plan layer, the apps, pagerank and the trace export.
    env = types.SimpleNamespace(
        torch=torch, dev=dev, cfg=cfg, lines=lines, rows=rows, corpus_file=corpus_file,
        corpus_bytes=corpus_bytes, work=work.name, nblocks=nblocks, BL=BL, W=W, E=E, K=K,
        want=want, expected=expected, run_cli=run_cli, check_counts=check_counts,
        median_s=median_s, cli_extra=[], counted=counted, by_path=by_path, oracle=oracle,
        check_pairs=check_pairs, smi=smi)
    dist_report = distributor_phase(env)
    from locust_tpu_torch.serve import ServeConfig

    # The serve jobs at the CLI's widths, the large ones at the daemon's
    # inline cap.
    env.serve_cfg, env.serve_big_bytes = {}, ServeConfig().max_corpus_bytes
    env.serve_daemon_extra = env.serve_submit_extra = []
    serve_report = serve_phase(env)
    env.pool_lease_s = 20.0  # above twice a daemon's start on the card, so no flap at start
    # A 16 MiB job at the inline cap is 52 blocks: under the default floor
    # of 64, so the pool's daemon shards from 16 blocks.
    env.pool_shard_min_blocks = 16
    pool_report = pool_phase(env)
    # The mesh's checkpointed world: a snapshot every 8 rounds, both ranks
    # crashed writing the one of round 24, so the resume starts at 16.
    env.mesh_ckpt_every, env.mesh_crash_gen = 8, 24
    mesh_report = mesh_phase(env)
    plan_phase(env)
    app_mbs = apps_phase(env)
    pagerank_report = pagerank_phase(env)
    mesh_apps_report = mesh_apps_phase(env)
    trace_phase(env)
    attribution = attribution_phase(env)
    debug_faults_phase(env)
    zipf_report = zipf_phase(env)

    with phase("times at the main path's shapes"):
        x = torch.from_numpy(np.ascontiguousarray(rows[:BL])).to(dev)
        # cuda_ms: events around back-to-back calls, what a caller waits
        # for (host dispatch included); device_ms: the device ops alone.
        def tok_kernel():
            return tokenize_block_kernel(x, E, K)

        def tok_plain():
            return tokenize_reference(x, E, K)

        def fused_kernel():
            return fused_block_preagg(x, cfg_f)

        # Kernels A and C are host-bound: their wall times over 200 calls,
        # which spread less between runs than 20 do.
        a_ms, c_ms = cuda_ms(torch, tok_kernel, reps=200), cuda_ms(torch, fused_kernel, reps=200)
        a_plain = cuda_ms(torch, tok_plain)
        a_ops, a_dev, a_own = call_profile(torch, tok_kernel, "tokenize_kernel")
        a_plain_dev = device_ms(torch, tok_plain)
        # In: the block; out: keys, valid and the overflow total.
        a_bound, a_by = bound_ms(roofline.tokenize_min_bytes(BL, W, E, K),
                                 roofline.tokenize_min_ops(BL, W))
        log(f"  tokenizer [{BL},{W}] E={E} K={K}: kernel {a_ms:.4f} ms, {a_ops:g} device ops "
            f"per call, device {a_dev:.4f} ms, the kernel's own {a_own:.4f} ms "
            f"({a_bound / a_own:.4f} of the bound); plain {a_plain:.4f} ms (device "
            f"{_ms(a_plain_dev)}), bound {a_bound:.6f} ms ({a_by})")
        if a_ops != 1:
            raise AssertionError(f"a tokenizer call is {a_ops:g} device ops, not 1")

        b_rows = {}
        # The WordCount fold's sort, a block's alone (the staged run's
        # Process stage), and the tf fold's: the pair table plus a block
        # of (word, doc) emits, key_lanes + 1 key lanes + the value.
        tf_n = default_pairs_capacity(cfg) + cfg.emits_per_block
        for n, width in ((cfg.resolved_table_size + cfg.emits_per_block, cfg.key_lanes + 1),
                         (cfg.emits_per_block, cfg.key_lanes + 1), (tf_n, cfg.key_lanes + 2)):
            key = torch.randint(0, 2**31 - 1, (n,), device=dev, dtype=torch.int32)
            pay = torch.randint(0, 2**31 - 1, (n, width), device=dev, dtype=torch.int32)

            def sort_kernel():
                return bitonic_sort_rows(key, pay)

            def sort_plain():
                return bitonic_network_reference(key, pay)

            def sort_stable():
                return bitonic_reference(key, pay)

            def sort_library():
                order = torch.sort(key.to(torch.int64) & 0xFFFFFFFF).indices
                return key[order], pay[order]

            # The kernel and torch.sort + gather in turns (library, kernel,
            # kernel, library), each the mean of its two readings.
            turns = {f: [] for f in (sort_kernel, sort_library)}
            for f in (sort_library, sort_kernel, sort_kernel, sort_library):
                turns[f].append((cuda_ms(torch, f), device_ms(torch, f)))
            mean = {f: (float(np.mean([w for w, _ in r])),
                        None if None in [d for _, d in r] else float(np.mean([d for _, d in r])))
                    for f, r in turns.items()}
            # The network reference is a thousand torch ops a call: a few
            # calls time it, and keep the profiler's event list short.
            times = [mean[sort_kernel], (cuda_ms(torch, sort_plain, reps=3, warmup=1),
                                         device_ms(torch, sort_plain, reps=3)),
                     mean[sort_library]]
            s_ms, s_dev = cuda_ms(torch, sort_stable), device_ms(torch, sort_stable)
            # CUDA launches of one kernel sort, as the profiler saw them:
            # five calls after a first call and a marker op, counted from
            # the marker on (the profiler may miss the start of a recording).
            def five_sorts():
                sort_kernel()
                torch.ones(1, device=dev).add_(1)
                torch.cuda.synchronize()
                for _ in range(5):
                    sort_kernel()

            ev = device_events(torch, five_sorts)
            mark = max((e.time_range.start for e in ev if "bitonic" not in e.name),
                       default=float("inf"))
            counted_ev = sorted((e for e in ev if "bitonic" in e.name and e.time_range.start > mark),
                                key=lambda e: e.time_range.start)
            seen = len(counted_ev) / 5
            per = bitonic_sort_rows.cuda_launches  # as the wrapper reports them
            if per > 1 and len(counted_ev) == 5 * per:  # each launch's mean device time
                launch_us = [float(np.mean([counted_ev[c * per + j].time_range.elapsed_us()
                                            for c in range(5)])) for j in range(per)]
                gap_us = float(np.mean([b.time_range.start - a.time_range.end
                                        for c in range(5) for a, b in zip(
                                            counted_ev[c * per:(c + 1) * per - 1],
                                            counted_ev[c * per + 1:(c + 1) * per])]))
                log(f"  bitonic n={n}: device us per launch, in plan order (first tile, then "
                    f"cross and tile per stage; the last gathers the rows): "
                    f"{[round(u, 2) for u in launch_us]}; mean gap between launches "
                    f"{gap_us:.2f} us")
            if per < 1 or (seen and seen != per):
                raise AssertionError(f"bitonic n={n}: the profiler saw {seen} kernel launches "
                                     f"per sort, the wrapper reports {per}")
            b, by = bound_ms(roofline.bitonic_min_bytes(n, pay.shape[1]),
                             roofline.bitonic_min_ops(n))
            b_rows[n] = (times, b, by, per, width)
            (k_ms, k_dev), (p_ms, p_dev), (l_ms, l_dev) = times
            log(f"  bitonic n={n} (pad {padded_size(n)}) x {pay.shape[1]} payloads, "
                f"{plan_steps(n)} plan steps in {per} CUDA launches per sort (profiler saw "
                f"{seen or 'none'} per sort over 5): "
                f"kernel {k_ms:.4f} ms (device {_ms(k_dev)}; readings {turns[sort_kernel]}), "
                f"torch.sort+gather {l_ms:.4f} ms (device {_ms(l_dev)}; readings "
                f"{turns[sort_library]}), network reference {p_ms:.4f} ms (device {_ms(p_dev)}), "
                f"stable plain {s_ms:.4f} ms (device {_ms(s_dev)}), bound {b:.6f} ms ({by}), "
                f"kernel device time {_ms(k_dev)} = "
                f"{'not measured' if k_dev is None else f'{b / k_dev:.4f} of the bound'}")
        fold_n = cfg.resolved_table_size + cfg.emits_per_block
        ((k_ms, k_dev), (p_ms, _), (l_ms, _)), b, by, b_launches, _ = b_rows[fold_n]

        def fused_plain():
            return fused_preagg_reference(x, cfg_f)

        def fused_library():
            # The same distinct keys and counts by the tokenizer kernel and
            # one library call.
            keys, valid, _ = tokenize_block_kernel(x, E, K)
            return torch.unique(pack_keys(keys)[valid], dim=0, return_counts=True)

        c_ops, c_dev, c_own = call_profile(torch, fused_kernel, "fused_preagg_kernel")
        c_plain, c_plain_dev = cuda_ms(torch, fused_plain, reps=5), device_ms(torch, fused_plain,
                                                                            reps=5)
        c_lib, c_lib_dev = cuda_ms(torch, fused_library), device_ms(torch, fused_library)
        tab, res, _, _ = fused_kernel()
        # In: the block; out: lanes, count and valid of every table and
        # residual row, the overflow and the flag.
        c_bytes = roofline.fused_min_bytes(BL, W, K)
        if c_bytes != BL * W + (tab.size + res.size) * (K + 5) + 5:
            raise AssertionError(f"kernel C wrote {tab.size} + {res.size} rows, not the "
                                 "rows utils/roofline.py counts")
        c_bound, c_by = bound_ms(c_bytes, roofline.fused_min_ops(BL, W))
        log(f"  fused pre-aggregation [{BL},{W}] E={E} K={K}, {tab.size} table + {res.size} "
            f"residual rows: kernel {c_ms:.4f} ms, {c_ops:g} device ops per call, device "
            f"{c_dev:.4f} ms, the kernel's own {c_own:.4f} ms ({c_bound / c_own:.4f} of the "
            f"bound); plain {c_plain:.4f} ms (device {_ms(c_plain_dev)}), tokenizer + "
            f"torch.unique {c_lib:.4f} ms (device {_ms(c_lib_dev)}), bound {c_bound:.6f} ms "
            f"({c_by}, {c_bytes} bytes)")
        if c_ops != 1:
            raise AssertionError(f"a fused pre-aggregation call is {c_ops:g} device ops, not 1")
        fold_key = torch.randint(0, 2**31 - 1, (fold_n,), device=dev, dtype=torch.int32)
        fold_pay = torch.randint(0, 2**31 - 1, (fold_n, cfg.key_lanes + 1), device=dev,
                                 dtype=torch.int32)
        b_ops, _, b_own = call_profile(torch, lambda: bitonic_sort_rows(fold_key, fold_pay),
                                       "bitonic")
        tf_key = torch.randint(0, 2**31 - 1, (tf_n,), device=dev, dtype=torch.int32)
        tf_pay = torch.randint(0, 2**31 - 1, (tf_n, cfg.key_lanes + 2), device=dev,
                               dtype=torch.int32)
        tf_ops, _, tf_own = call_profile(torch, lambda: bitonic_sort_rows(tf_key, tf_pay),
                                         "bitonic")
        log(f"  bitonic at the tf fold's shape n={tf_n} x {cfg.key_lanes + 2} payloads: "
            f"{tf_ops:g} device ops per call, the kernel's own {tf_own:.4f} ms "
            f"({b_rows[tf_n][1] / tf_own:.4f} of the bound)")

    with phase("times of kernel C at the run_stream segment shape"):
        seg_lines = seg * BL
        xs = torch.from_numpy(np.ascontiguousarray(rows[:seg_lines])).to(dev)

        def seg_kernel():
            return fused_block_preagg(xs, cfg_f)

        def seg_plain():
            return fused_preagg_reference(xs, cfg_f)

        def seg_library():
            keys, valid, _ = tokenize_block_kernel(xs, E, K)
            return torch.unique(pack_keys(keys)[valid], dim=0, return_counts=True)

        cs_ms = cuda_ms(torch, seg_kernel, reps=100)
        cs_ops, cs_dev, cs_own = call_profile(torch, seg_kernel, "fused_preagg_kernel")
        cs_plain, cs_plain_dev = cuda_ms(torch, seg_plain, reps=5), device_ms(torch, seg_plain, reps=5)
        cs_lib, cs_lib_dev = cuda_ms(torch, seg_library), device_ms(torch, seg_library)
        tab_s, res_s, _, _ = seg_kernel()
        # In: the segment's lines; out: every table and residual row
        # (lanes, count, valid), the overflow and the flag.
        cs_bytes = roofline.fused_min_bytes(seg_lines, W, K)
        if cs_bytes != seg_lines * W + (tab_s.size + res_s.size) * (K + 5) + 5:
            raise AssertionError(f"kernel C wrote {tab_s.size} + {res_s.size} rows at the "
                                 "segment shape, not the rows utils/roofline.py counts")
        cs_bound, cs_by = bound_ms(cs_bytes, roofline.fused_min_ops(seg_lines, W))
        log(f"  fused pre-aggregation [{seg_lines},{W}] E={E} K={K} ({seg} blocks, "
            f"{seg_lines // 32} tiles), {tab_s.size} table + {res_s.size} residual rows: kernel "
            f"{cs_ms:.4f} ms, {cs_ops:g} device ops per call, device {cs_dev:.4f} ms, the "
            f"kernel's own {cs_own:.4f} ms ({cs_bound / cs_own:.4f} of the bound); plain "
            f"{cs_plain:.4f} ms (device {_ms(cs_plain_dev)}), tokenizer + torch.unique "
            f"{cs_lib:.4f} ms (device {_ms(cs_lib_dev)}), bound {cs_bound:.6f} ms ({cs_by}, "
            f"{cs_bytes} bytes)")
        if cs_ops != 1:
            raise AssertionError(f"a fused pre-aggregation call at the segment shape is "
                                 f"{cs_ops:g} device ops, not 1")

    sub = rows[: 8 * BL]
    for mode, e in (("bitonic", eng), ("fused", engines["fused"]), ("hasht", engines["hasht"])):
        with phase(f"where the device time goes: torch.profiler over run_fused under {mode}, 8 blocks"):
            kern = device_events(torch, lambda: e.run_fused(sub))
            if not kern:
                log("  the profiler recorded no device time: busy share not measured")
                continue
            span = max(k.time_range.end for k in kern) - min(k.time_range.start for k in kern)
            by_name = collections.Counter()
            for k in kern:
                by_name[k.name[:70]] += k.time_range.elapsed_us()
            busy = sum(by_name.values())
            sort_us = sum(us for name, us in by_name.items() if "bitonic" in name)
            log(f"  {len(kern)} device ops ({len(kern) / 8:g} per block), busy {busy / 1e3:.3f} "
                f"ms of a {span / 1e3:.3f} ms "
                f"device window: busy share {busy / span:.3f}; the bitonic kernel "
                f"{sort_us / 1e3:.3f} ms = {sort_us / busy:.1%} of busy")
            for name, us in by_name.most_common(12):
                log(f"  {us / 1e3:9.3f} ms  {us / busy:6.1%}  {name}")

    stream_busy = {}
    for mode, e, n, unit, kname in (("fused", fe, nseg, "segment", "fused_preagg"),
                                    ("bitonic", eng, nblocks, "block", "bitonic")):
        for reader in ("native", "python"):
            with phase(f"where the device time goes: torch.profiler over run_stream under {mode} "
                       f"through the {reader} reader, {nblocks} blocks"):
                kern = device_events(torch, lambda: e.run_stream(
                    stream_of_corpus(use_native=reader == "native")))
                if not kern:
                    log("  the profiler recorded no device time: busy share not measured")
                    continue
                span = max(k.time_range.end for k in kern) - min(k.time_range.start for k in kern)
                by_name = collections.Counter()
                for k in kern:
                    by_name[k.name[:70]] += k.time_range.elapsed_us()
                busy = sum(by_name.values())
                stream_busy[f"{mode}_{reader}"] = busy / span
                k_us = sum(us for name, us in by_name.items() if kname in name)
                log(f"  {len(kern)} device ops ({len(kern) / n:g} per {unit}), busy "
                    f"{busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms device window: busy share "
                    f"{busy / span:.3f}; {kname} {k_us / 1e3:.3f} ms = {k_us / busy:.1%} of busy")
                for name, us in by_name.most_common(8):
                    log(f"  {us / 1e3:9.3f} ms  {us / busy:6.1%}  {name}")
    log(f"  run_stream busy share of the device window: {json.dumps(stream_busy)}")
    with phase("roofline: utils/roofline.summarize beside each MB/s; the kernels' "
               "least-bytes utilisation"):
        kind = torch.cuda.get_device_name(0)
        roof = roofline_rows(env, mode_mbs, stream_mbs, kind)
        peak = roofline.PEAK_HBM_GB_S.get(kind)
        kernel_util = {}
        for name, nbytes, own in (
                ("tokenize", roofline.tokenize_min_bytes(BL, W, E, K), a_own),
                ("bitonic_sort", roofline.bitonic_min_bytes(fold_n, cfg.key_lanes + 1), b_own),
                ("bitonic_sort_tf_fold", roofline.bitonic_min_bytes(tf_n, cfg.key_lanes + 2),
                 tf_own),
                ("fused_fold", c_bytes, c_own), ("fused_fold_segment", cs_bytes, cs_own)):
            pct = None if peak is None else 100.0 * nbytes / (own / 1e3) / (peak * 1e9)
            if pct is not None and pct > 100:
                raise AssertionError(f"{name}: {pct:.2f}% of the peak from {nbytes} bytes in "
                                     f"{own} ms")
            kernel_util[name] = pct
            log(f"  {name}: {nbytes} least bytes in the kernel's own {own:.4f} ms = "
                f"{'not measured' if pct is None else f'{pct:.3f}%'} of {peak} GB/s")
    work.cleanup()

    log(f"card: {smi}")
    report = {"kernels": [
        {"name": "tokenize", "route": "cuda", "status": "ported, redesigned",
         "source": "locust_tpu_torch/csrc/tokenize.cu",
         "replaces": "locust_tpu/ops/pallas/tokenize.py:35",
         "launches": by_path["cli"]["tokenize"],  # the default CLI (bitonic)
         "launches_by_path": {p: c["tokenize"] for p, c in by_path.items()},
         "max_abs_err": err_a,
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound, "bound_by": a_by,
         "library_ms": None, "device_ms": a_dev, "kernel_device_ms": a_own,
         "device_ops_per_call": a_ops, "shape": f"[{BL},{W}] E={E} K={K}"},
        {"name": "bitonic_sort", "route": "cuda", "status": "ported, redesigned",
         "source": "locust_tpu_torch/csrc/bitonic.cu",
         "replaces": "locust_tpu/ops/pallas/sort.py:87",
         "launches": by_path["cli"]["bitonic_sort"],
         "launches_by_path": {p: c["bitonic_sort"] for p, c in by_path.items()},
         "cuda_launches_per_sort": b_launches, "plan_steps": plan_steps(fold_n),
         "max_abs_err": err_b,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b, "bound_by": by,
         "library_ms": l_ms, "device_ms": k_dev, "kernel_device_ms": b_own,
         "device_ops_per_call": b_ops,
         "shape": f"n={fold_n} x {cfg.key_lanes + 1} payloads",
         "by_shape": {str(n): {"cuda_launches_per_sort": nl, "plan_steps": plan_steps(n),
                               "ms": t[0][0],
                               "device_ms": t[0][1], "plain_ms": t[1][0], "library_ms": t[2][0],
                               "library_device_ms": t[2][1], "bound_ms": bb}
                      for n, (t, bb, _, nl, _) in b_rows.items()},
         "tf_fold": {"shape": f"n={tf_n} x {cfg.key_lanes + 2} payloads",
                     "launches": by_path["cli_tfidf"]["bitonic_sort"],
                     "cuda_launches_per_sort": b_rows[tf_n][3], "plan_steps": plan_steps(tf_n),
                     "ms": b_rows[tf_n][0][0][0], "device_ms": b_rows[tf_n][0][0][1],
                     "kernel_device_ms": tf_own, "device_ops_per_call": tf_ops,
                     "plain_ms": b_rows[tf_n][0][1][0], "library_ms": b_rows[tf_n][0][2][0],
                     "library_device_ms": b_rows[tf_n][0][2][1],
                     "bound_ms": b_rows[tf_n][1], "bound_by": b_rows[tf_n][2]}},
        {"name": "fused_fold", "route": "cuda", "status": "ported, redesigned",
         "source": "locust_tpu_torch/csrc/fused_fold.cu",
         "replaces": "locust_tpu/ops/pallas/fused_fold.py:155",
         "launches": by_path["cli_fused"]["fused_fold"],
         "launches_by_path": {p: c["fused_fold"] for p, c in by_path.items()},
         "max_abs_err": err_c,
         "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound, "bound_by": c_by,
         "library_ms": c_lib, "device_ms": c_dev, "kernel_device_ms": c_own,
         "device_ops_per_call": c_ops,
         "shape": f"[{BL},{W}] E={E} K={K}, {tab.size} table + {res.size} residual rows",
         "segment": {"shape": f"[{seg * BL},{W}] E={E} K={K}, {tab_s.size} table + "
                              f"{res_s.size} residual rows ({seg} blocks)",
                     "launches": by_path["run_stream_fused"]["fused_fold"],
                     "ms": cs_ms, "plain_ms": cs_plain, "bound_ms": cs_bound, "bound_by": cs_by,
                     "library_ms": cs_lib, "device_ms": cs_dev, "kernel_device_ms": cs_own,
                     "device_ops_per_call": cs_ops, "plain_device_ms": cs_plain_dev,
                     "library_device_ms": cs_lib_dev}},
        {"name": "pagerank_gather_add", "route": "cuda", "status": "port-only",
         "source": "locust_tpu_torch/csrc/pagerank.cu",
         "replaces": "index_add_ (apps/pagerank.py)",
         "launches": by_path["cli_pagerank"]["pagerank"],
         "launches_by_path": {p: c.get("pagerank", 0) for p, c in by_path.items()},
         **pagerank_report["kernel"],
         "mesh_slots": mesh_apps_report["pagerank"]["gather_add_world2"]},
        {"name": "partition", "route": "cuda", "status": "port-only",
         "source": "locust_tpu_torch/csrc/partition.cu",
         "replaces": "torch sort, bincount, index_put_ and cat (parallel/shuffle.py)",
         "launches": by_path["mesh_w1_bitonic"]["partition"],
         "launches_by_path": {p: c.get("partition", 0) for p, c in by_path.items()},
         "shapes_checked_in_process": mesh_apps_report[
             "partition_shapes_checked_in_this_process"]},
    ], "run_fused_mb_s": mode_mbs, "run_stream_mb_s": stream_mbs,
       "run_stream_busy_share": stream_busy, "apps_mb_s": app_mbs,
       "pagerank": pagerank_report, "zipf_run_stream": zipf_report,
       "kernel_hbm_utilization_pct": kernel_util,
       "roofline": {k: {f: r[f] for f in ("min_bytes", "achieved_min_gb_s", "hbm_utilization_pct",
                                          "est_sort_traffic_gb", "achieved_sort_gb_s",
                                          "sort_passes")}
                    for k, r in roof.items()},
       "attribution": attribution, "distributor": dist_report, "serve": serve_report,
       "pool": pool_report, "mesh": mesh_report, "mesh_apps": mesh_apps_report}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--counted-child"]:
        raise SystemExit(_counted_child(sys.argv[2], sys.argv[3], sys.argv[4:]))
    raise SystemExit(main())
