#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``locust_tpu_torch/csrc`` with nvcc,
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
against the port's schema.  The kernels' launch counters are set to 0
just before each path and read just after it; each path must launch each
kernel exactly as often as its blocks demand.  The ``kernels`` line
reports each kernel's count on its CLI path as ``launches`` and every
path's in ``launches_by_path``.

The times phase reports, per kernel, the wall time of a call, its device
ops and their device time as the profiler records them, and the kernel's
own device time; a call of the tokenizer or of the fused pre-aggregation
must be one device op.  Kernel B is timed at the WordCount fold's, a
block's and the tf fold's shapes, kernel C at the block shape and at the
``run_stream`` segment shape.

Output: one line per check, the card's name and power limit, one JSON
line with each kernel's numbers (and the MB/s of the runners and apps
and the pagerank report), and last a JSON line
``{"ok": true, "device": {...}}``.  Every phase raises on failure, so the
script exits non-zero and prints no result; it also refuses to run
without CUDA or without the ``locust_tpu_torch`` package beside it.
Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
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
        log(f"  oracle: {n_docs} docs, {len(tf)} distinct (word, doc) pairs, "
            f"{len({w for w, _ in tf})} distinct words")
        for app, mode, sorts in (("index", "bitonic", 0), ("tfidf", "bitonic", env.nblocks)):
            name = f"cli_{app}"
            out = env.run_cli(name, [app, env.corpus_file, "--lines-per-doc", str(lpd),
                                     "--sort-mode", mode, *env.cli_extra])
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
    on the card and on the CPU, the largest |delta rank| against a
    float64 oracle and between the two, the printed lines that differ,
    and iterations per second."""
    from locust_tpu_torch.apps.pagerank import pagerank

    iters, damping = 20, 0.85
    with phase("pagerank over a seeded edge list at web-Google's scale, 20 iterations"):
        n, src, dst = synthetic_web_graph()
        path = os.path.join(env.work, "edges.txt")
        with open(path, "wb") as f:
            f.write("".join(f"{a}\t{b}\n" for a, b in zip(src.tolist(), dst.tolist())).encode())
        deg = np.bincount(src, minlength=n)
        log(f"  {n} nodes, {len(src)} edges, {int((deg == 0).sum())} dangling nodes, "
            f"max out-degree {int(deg.max())}, max in-degree "
            f"{int(np.bincount(dst, minlength=n).max())}")
        argv = ["pagerank", path, "--num-nodes", str(n), "--num-iters", str(iters)]
        out_dev = env.run_cli("cli_pagerank", argv + env.cli_extra)
        out_cpu = env.run_cli("cli_pagerank_cpu", argv + ["--backend", "cpu"])
        for name in ("cli_pagerank", "cli_pagerank_cpu"):  # no kernel on this path
            env.expected[name] = {"tokenize": 0, "bitonic_sort": 0, "fused_fold": 0}
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
        env.check_counts("cli_pagerank", "cli_pagerank_cpu")
        pagerank(src, dst, n, 1, damping, device=env.dev)  # warm-up
        m, runs = env.median_s(lambda: pagerank(src, dst, n, iters, damping, device=env.dev))
        out = {"nodes": n, "edges": int(len(src)), "iters": iters,
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
    return out


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

    with phase("build kernels"):
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        reports = _build.build()
        log(f"built {sorted(reports)} in {time.perf_counter() - t0:.2f} s")
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
                  (245760, "dups", 10), (245760, "sentinel", 10)]
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

        counters = {"tokenize": tokenize_block_kernel, "bitonic_sort": bitonic_sort_rows,
                    "fused_fold": fused_block_preagg}

        def counted(fn):
            """Run ``fn`` with every launch counter set to 0 just before it;
            returns its result and the counts read just after it."""
            for wrapper in counters.values():
                wrapper.launches = 0
            out = fn()
            torch.cuda.synchronize()
            return out, {name: wrapper.launches for name, wrapper in counters.items()}

        # Each path's exact count: one tokenizer launch per block; one
        # sort per block for the fold, two (Process + table merge) for
        # the staged run, which the CLI's default stage report runs.
        expected = {
            "run_fused": {"tokenize": nblocks, "bitonic_sort": nblocks, "fused_fold": 0},
            "timed_run": {"tokenize": nblocks, "bitonic_sort": 2 * nblocks, "fused_fold": 0},
            "cli": {"tokenize": nblocks, "bitonic_sort": 2 * nblocks, "fused_fold": 0},
        }
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

    def check_counts(*names):
        for name in names:
            got = by_path[name]
            log(f"  launches in {name}: {got}, expected {expected[name]}")
            if got != expected[name]:
                raise AssertionError(f"{name} did not launch each kernel as its path must: "
                                     f"{got} != {expected[name]}")

    def run_cli(name, argv):
        """The CLI as a user calls it; its stdout and this path's counts."""
        out = io.BytesIO()
        stdout = io.TextIOWrapper(out, write_through=True)
        with contextlib.redirect_stdout(stdout):
            rc, by_path[name] = counted(lambda: cli.main(argv))
        if rc != 0:
            raise AssertionError(f"CLI {argv} exited {rc}")
        return out.getvalue()  # before the wrapper, and with it `out`, is closed

    def median_s(fn, n=3):
        runs = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        return float(np.median(runs)), runs

    def stream_of_corpus():
        return StreamingCorpus(corpus_file, W, BL)

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
    with phase("run_stream over a StreamingCorpus of the corpus file: fused, then bitonic"):
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
        # What the stream is waiting for: the host reader alone, and the
        # fold loop over blocks read beforehand.
        m, runs = median_s(lambda: sum(1 for _ in stream_of_corpus()))
        stream_mbs["reader_alone"] = corpus_bytes / m / 1e6
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
        median_s=median_s, cli_extra=[])
    plan_phase(env)
    app_mbs = apps_phase(env)
    pagerank_report = pagerank_phase(env)
    trace_phase(env)

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
        a_bound, a_by = bound_ms(BL * W + BL * E * K + BL * E + 4, BL * W)
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
            times = [mean[sort_kernel], (cuda_ms(torch, sort_plain), device_ms(torch, sort_plain)),
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
            kb = padded_size(n).bit_length() - 1
            nbytes = 2 * n * 4 * (1 + pay.shape[1])
            b, by = bound_ms(nbytes, (padded_size(n) // 2) * kb * (kb + 1) // 2)
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
        (c_plain, c_plain_dev), (c_lib, c_lib_dev) = [
            (cuda_ms(torch, f), device_ms(torch, f)) for f in (fused_plain, fused_library)]
        tab, res, _, _ = fused_kernel()
        # In: the block; out: lanes, count and valid of every table and
        # residual row, the overflow and the flag.
        c_bytes = BL * W + (tab.size + res.size) * (K + 5) + 5
        c_bound, c_by = bound_ms(c_bytes, BL * W)
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
        cs_bytes = seg_lines * W + (tab_s.size + res_s.size) * (K + 5) + 5
        cs_bound, cs_by = bound_ms(cs_bytes, seg_lines * W)
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

    with phase(f"where the device time goes: torch.profiler over run_stream under fused, "
               f"{nblocks} blocks in {nseg} segments"):
        kern = device_events(torch, lambda: fe.run_stream(stream_of_corpus()))
        if not kern:
            log("  the profiler recorded no device time: busy share not measured")
        else:
            span = max(k.time_range.end for k in kern) - min(k.time_range.start for k in kern)
            by_name = collections.Counter()
            for k in kern:
                by_name[k.name[:70]] += k.time_range.elapsed_us()
            busy = sum(by_name.values())
            c_us = sum(us for name, us in by_name.items() if "fused_preagg" in name)
            log(f"  {len(kern)} device ops ({len(kern) / nseg:g} per segment), busy "
                f"{busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms device window: busy share "
                f"{busy / span:.3f}; kernel C {c_us / 1e3:.3f} ms = {c_us / busy:.1%} of busy")
            for name, us in by_name.most_common(12):
                log(f"  {us / 1e3:9.3f} ms  {us / busy:6.1%}  {name}")
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
    ], "run_fused_mb_s": mode_mbs, "run_stream_mb_s": stream_mbs, "apps_mb_s": app_mbs,
       "pagerank": pagerank_report}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
