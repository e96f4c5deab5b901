"""Shared pieces of the port's mesh tests (tests/test_torch_mesh_*.py).

The scenarios (a corpus, config overrides, engine and run arguments),
run the same way by a JAX mesh in the test process and by a port world
of processes on the CPU; a port world is this file run as a script, one
process per rank:

    python tests/torch_mesh_rig.py torch COORD N PID OUTDIR SUITE
    python tests/torch_mesh_rig.py jax COORD N PID OUTDIR SUITE

Rank 0 writes ``OUTDIR/<torch|jax>.json`` (each scenario's pairs and
counters) and ``OUTDIR/<scenario>.npz`` (its gathered table); the ``jax``
form runs a JAX pod of N processes of one CPU device each.  Every process's output
goes to files in OUTDIR.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SORT_MODES = ("hash", "hashp", "hashp2", "hashp1", "hash1", "radix", "bitonic", "lex",
              "hasht", "hasht-mxu", "fused")
BASE = [b"the quick brown fox jumps over the dog",
        b"pack my box with five dozen liquor jugs",
        b"the five boxing wizards jump quickly",
        b"sphinx of black quartz judge my vow"]
# Block lines a multiple of 64 and width 128: JAX runs its kernels'
# interpret mode and engages "fused" as on the single-device engine.
CFG = {"block_lines": 64, "line_width": 128, "emits_per_line": 8}


def lines_of(kind: str) -> list[bytes]:
    """The seeded corpora of tests/test_distributed.py, scaled to CFG."""
    if kind == "mixed":
        rng = np.random.default_rng(7)
        vocab = [b"word%d" % i for i in range(60)] + [b"the"] * 5
        return [b" ".join(rng.choice(vocab, size=rng.integers(0, 7)).tolist())
                for _ in range(700)]
    if kind == "hot":
        return [b"the the the the the the"] * 256
    if kind in ("skew", "trunc"):
        rng = np.random.default_rng(11 if kind == "skew" else 3)
        vocab = [b"word%d" % i for i in range(300 if kind == "skew" else 400)]
        return [b" ".join(rng.choice(vocab, size=6).tolist()) for _ in range(256)]
    if kind == "tight":
        return [b" ".join(b"w%04d" % (12 * i + j) for j in range(12)) for i in range(256)]
    if kind == "resume":
        return [b"alpha beta", b"beta gamma", b"alpha delta epsilon"] * 400
    if kind == "same":
        return [b"same same same"] * 256
    if kind == "hier":
        return [b"to be or not to be", b"that is the question",
                b"to be, to sleep; to dream", b"the the the the"] * 70
    raise KeyError(kind)


# name -> (corpus, cfg overrides, engine kwargs, run kwargs)
FLAT = {f"mode_{m}": ("mixed", {"sort_mode": m}, {}, {}) for m in SORT_MODES}
FLAT.update({
    "hot": ("hot", {}, {"skew_factor": 1.5}, {}),
    "skew": ("skew", {}, {"skew_factor": 0.1}, {}),
    "skew_hasht": ("skew", {"sort_mode": "hasht"}, {"skew_factor": 0.1}, {}),
    "skew_bitonic": ("skew", {"sort_mode": "bitonic"}, {"skew_factor": 0.1}, {}),
    "drop": ("skew", {}, {"skew_factor": 0.1, "on_overflow": "drop"}, {}),
    "trunc": ("trunc", {}, {"shard_capacity": 8}, {}),
    "tight": ("tight", {"emits_per_line": 16}, {"bin_capacity": 8, "shard_capacity": 256}, {}),
    "count": ("same", {}, {"combine": "count"}, {}),
    "sync1": ("mixed", {"sort_mode": "hasht"}, {}, {"stats_sync_every": 1}),
})
# name -> ((slices, devices per slice), corpus, cfg overrides, engine kwargs)
HIER = {
    "h2x2": ((2, 2), "hier", {}, {}),
    "h4x1": ((4, 1), "hier", {}, {}),
    "h1x4": ((1, 4), "hier", {}, {}),
    "h2x2_skew": ((2, 2), "tight", {"emits_per_line": 16},
                  {"skew_factor": 0.1, "shard_capacity": 2048}),
    "h2x2_same": ((2, 2), "same", {}, {}),
    "h2x2_count": ((2, 2), "same", {}, {"combine": "count"}),
    "h2x2_trunc": ((2, 2), "tight", {"emits_per_line": 16},
                   {"skew_factor": 0.1, "shard_capacity": 8}),
}
HIER_MODES = {f"hmode_{m}": ((2, 2), "hier", {"sort_mode": m}, {}) for m in SORT_MODES}
STATS = ("distinct", "drain_rounds", "emit_overflow", "shuffle_overflow", "truncated",
         "fused_kernel", "fused_demoted")


def summary(res, table: dict) -> tuple[dict, dict]:
    out = {k: getattr(res, k) for k in STATS}
    out["pairs"] = [[k.hex(), v] for k, v in res.to_host_pairs()]
    return out, {k: np.asarray(v) for k, v in table.items()}


def _rows(pkg, kind: str, width: int):
    return pkg.core.bytes_ops.strings_to_rows(lines_of(kind), width)


def run_flat(pkg, parallel, mesh, name: str):
    """One FLAT scenario on ``mesh`` through package ``pkg`` (a namespace
    of its EngineConfig and modules); returns ``(summary, table)``."""
    kind, cfg_kw, eng_kw, run_kw = FLAT[name]
    cfg = pkg.EngineConfig(**{**CFG, **cfg_kw})
    res = parallel.DistributedMapReduce(mesh, cfg, **eng_kw).run(
        _rows(pkg, kind, cfg.line_width), **run_kw)
    return summary(res, pkg.table_of(res))


def run_hier(pkg, parallel, make_mesh_2d, name: str):
    shape, kind, cfg_kw, eng_kw = {**HIER, **HIER_MODES}[name]
    cfg = pkg.EngineConfig(**{**CFG, **cfg_kw})
    res = parallel.HierarchicalMapReduce(make_mesh_2d(*shape), cfg, **eng_kw).run(
        _rows(pkg, kind, cfg.line_width))
    return summary(res, pkg.table_of(res))


def crash_resume(make_engine, rows, ckpt: str, crash_at: int = 2) -> dict:
    """Crash at the ``crash_at``-th step of a checkpointed run, resume with
    a fresh engine; a third run over the complete snapshot steps 0 times."""
    eng = make_engine()
    real, calls = eng._step, {"n": 0}

    def crashing(*a):
        if calls["n"] == crash_at:
            raise RuntimeError("injected crash")
        calls["n"] += 1
        return real(*a)

    eng._step = crashing
    try:
        eng.run(rows, checkpoint_dir=ckpt, checkpoint_every=1, stats_sync_every=1)
    except RuntimeError as e:
        assert "injected crash" in str(e)
    else:
        raise AssertionError("the crash did not fire")
    return resume(make_engine, rows, ckpt)


def resume(make_engine, rows, ckpt: str) -> dict:
    eng = make_engine()
    real, steps = eng._step, {"n": 0}

    def counting(*a):
        steps["n"] += 1
        return real(*a)

    eng._step = counting
    res = eng.run(rows, checkpoint_dir=ckpt, checkpoint_every=1)
    out = {"pairs": [[k.hex(), v] for k, v in res.to_host_pairs()],
           "resumed_rounds": steps["n"],
           "nrounds": -(-rows.shape[0] // eng.lines_per_round)}
    steps["n"] = 0
    again = eng.run(rows, checkpoint_dir=ckpt, checkpoint_every=1)
    out["third_run_steps"] = steps["n"]
    out["third_run_same"] = again.to_host_pairs() == res.to_host_pairs()
    return out


def _torch_pkg():
    import types

    import locust_tpu_torch.core.bytes_ops  # noqa: F401
    from locust_tpu_torch import core
    from locust_tpu_torch.config import EngineConfig

    return types.SimpleNamespace(EngineConfig=EngineConfig, core=core,
                                 table_of=lambda res: res.gather())


def jax_pkg():
    import types

    import locust_tpu.core.bytes_ops  # noqa: F401
    from locust_tpu import core
    from locust_tpu.config import EngineConfig

    def table_of(res):
        from locust_tpu.parallel.mesh import gather_host_array

        return {k: gather_host_array(getattr(res.table, k))
                for k in ("key_lanes", "values", "valid")}

    return types.SimpleNamespace(EngineConfig=EngineConfig, core=core, table_of=table_of)


def wait_for(path: str, timeout: float = 240.0) -> None:
    import time

    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)


def _suite_flat(pkg, parallel, out: dict, tables: dict, outdir: str) -> None:
    """The port world of 2's suite: every FLAT scenario, run_stream ==
    run, and a crash and resume."""
    mesh = parallel.make_mesh(device="cpu")
    for name in FLAT:
        out[name], tables[name] = run_flat(pkg, parallel, mesh, name)
    cfg = pkg.EngineConfig(**CFG)
    eng = parallel.DistributedMapReduce(mesh, cfg)
    rows = _rows(pkg, "mixed", cfg.line_width)
    lpr = eng.lines_per_round
    out["stream"] = [[k.hex(), v] for k, v in eng.run_stream(
        rows[i:i + lpr] for i in range(0, rows.shape[0], lpr)).to_host_pairs()]
    rrows = _rows(pkg, "resume", cfg.line_width)
    out["crash"] = crash_resume(lambda: parallel.DistributedMapReduce(mesh, cfg), rrows,
                                os.path.join(outdir, "ckpt_flat"))


def _suite_hier(pkg, parallel, out: dict, tables: dict, outdir: str) -> None:
    """The port world of 4's suite: every HIER scenario, run_stream ==
    run, a hierarchical and a flat crash and resume over 4 processes,
    the debug-checks replication check (healthy, then doctored)."""
    mk = lambda s, d: parallel.make_mesh_2d(s, d, device="cpu")  # noqa: E731
    for name in HIER:
        out[name], tables[name] = run_hier(pkg, parallel, mk, name)
    cfg = pkg.EngineConfig(**CFG)
    m22 = mk(2, 2)
    h = parallel.HierarchicalMapReduce(m22, cfg)
    rows = _rows(pkg, "hier", cfg.line_width)
    lpr = h.lines_per_round
    out["hstream"] = [[k.hex(), v] for k, v in h.run_stream(
        rows[i:i + lpr] for i in range(0, rows.shape[0], lpr)).to_host_pairs()]
    rrows = _rows(pkg, "resume", cfg.line_width)
    out["hcrash"] = crash_resume(lambda: parallel.HierarchicalMapReduce(m22, cfg), rrows,
                                 os.path.join(outdir, "ckpt_hier"))
    flat = parallel.make_mesh(device="cpu")
    out["crash4"] = crash_resume(lambda: parallel.DistributedMapReduce(flat, cfg), rrows,
                                 os.path.join(outdir, "ckpt_flat4"))
    os.environ["LOCUST_DEBUG_CHECKS"] = "1"
    out["debug_healthy"] = [[k.hex(), v] for k, v in h.run(rows).to_host_pairs()]
    orig = h._combine_dbg

    def doctored(table, stats):
        parts = orig(table, stats)
        parts["values"][1] += 1  # slice 1 differs
        return parts

    h._combine_dbg = doctored
    try:
        h.run(rows)
        out["debug_doctored"] = "no error"
    except RuntimeError as e:
        out["debug_doctored"] = str(e)
    del os.environ["LOCUST_DEBUG_CHECKS"]
    for bad in ((3, None), (4, 4)):
        try:
            parallel.make_mesh_2d(*bad, device="cpu")
            out[f"mesh_error_{bad[0]}"] = "no error"
        except ValueError as e:
            out[f"mesh_error_{bad[0]}"] = str(e)
    try:
        parallel.HierarchicalMapReduce(flat, cfg)
        out["axes_error"] = "no error"
    except ValueError as e:
        out["axes_error"] = str(e)


# The cross-package resume: both packages' worlds of 2 run at once, each
# crashes a run into its own directory, then resumes the other's.
RESUME_CFG = {"block_lines": 8, "line_width": 64, "emits_per_line": 8}


def _suite_resume(pkg, parallel, mesh, out: dict, outdir: str, me: str, other: str,
                  barrier, rank: int) -> None:
    cfg = pkg.EngineConfig(**RESUME_CFG)
    make = lambda: parallel.DistributedMapReduce(mesh, cfg)  # noqa: E731
    rows = pkg.core.bytes_ops.strings_to_rows(BASE * make().lines_per_round, cfg.line_width)
    own = os.path.join(outdir, f"ckpt_{me}")
    eng = make()
    real, calls = eng._step, {"n": 0}

    def crashing(*a):
        if calls["n"] == 2:
            raise RuntimeError("injected crash")
        calls["n"] += 1
        return real(*a)

    eng._step = crashing
    try:
        eng.run(rows, checkpoint_dir=own, checkpoint_every=1, stats_sync_every=1)
    except RuntimeError:
        pass
    barrier()
    if rank == 0:
        open(os.path.join(outdir, f"{me}.crashed"), "w").close()
    wait_for(os.path.join(outdir, f"{other}.crashed"))
    out["resumed_other"] = resume(make, rows, os.path.join(outdir, f"ckpt_{other}"))
    out["n_lines"] = int(rows.shape[0])


# ------------------------------------------------------------ the mesh apps
# The scenarios of tests/test_apps.py for the mesh apps (PageRank, the
# inverted index, the sample sort), each run by both packages through
# ``apps`` (``locust_tpu.apps`` or ``locust_tpu_torch.apps``).

APP_CFG = {"block_lines": 8, "line_width": 64, "emits_per_line": 8}


def pr_graph(kind: str):
    """``(num_nodes, src, dst)``: uniform graphs of 8 edges a node
    (``g64``, ``g1000``, ``g1003``), one node's edges into node 0 with
    every other node dangling (``dangling``: most (sender, destination
    shard) pairs carry nothing, a shard's send slots are empty), and a
    skewed graph with dangling nodes (``zipf``)."""
    if kind == "dangling":
        return 64, np.array([1, 1, 1], np.int32), np.array([0, 0, 0], np.int32)
    if kind == "zipf":
        rng = np.random.default_rng(2)
        n, e = 1003, 9000
        src = rng.integers(0, n, e).astype(np.int32)
        src[src % 5 == 0] = 7
        return n, src, (rng.zipf(1.4, e) % n).astype(np.int32)
    n = int(kind[1:])
    rng = np.random.default_rng(1)
    return (n, rng.integers(0, n, n * 8).astype(np.int32),
            rng.integers(0, n, n * 8).astype(np.int32))


# name -> (class, graph, iterations)
PAGERANK = {
    "sharded_64": ("ShardedPageRank", "g64", 15),
    "sharded_1000": ("ShardedPageRank", "g1000", 15),
    "sharded_1003": ("ShardedPageRank", "g1003", 15),
    "sharded_dangling": ("ShardedPageRank", "dangling", 10),
    "sharded_zipf": ("ShardedPageRank", "zipf", 20),
    "distributed_1003": ("DistributedPageRank", "g1003", 15),
    "distributed_zipf": ("DistributedPageRank", "zipf", 20),
}


def run_pagerank(apps, mesh, name: str) -> np.ndarray:
    cls, graph, iters = PAGERANK[name]
    n, src, dst = pr_graph(graph)
    return np.asarray(getattr(apps, cls)(mesh, n).run(src, dst, num_iters=iters))


def index_docs(kind: str) -> dict:
    """doc id -> text, the corpora of tests/test_apps.py's mesh index
    tests; ``long`` has lines past the 8-token cap (dropped postings)."""
    if kind == "oracle":
        rng = np.random.default_rng(5)
        vocab = [f"term{i}".encode() for i in range(40)] + [b"the"] * 4
        return {d: b" ".join(rng.choice(vocab, size=rng.integers(0, 7)).tolist())
                for d in range(200)}
    if kind == "skew":
        rng = np.random.default_rng(9)
        vocab = [f"w{i}".encode() for i in range(120)]
        return {d: b" ".join(rng.choice(vocab, size=5).tolist()) for d in range(64)}
    vocab = [f"w{i}".encode() for i in range(100)]
    if kind == "capacity":
        return {d: b" ".join(vocab[d % 50:d % 50 + 6]) for d in range(64)}
    if kind == "long":
        return {d: b" ".join(vocab[d % 30:d % 30 + 3 + d % 9]) for d in range(48)}
    raise KeyError(kind)


# name -> (corpus, index kwargs)
INDEX = {"oracle": ("oracle", {}), "skew": ("skew", {"skew_factor": 0.2}),
         "capacity": ("capacity", {"pairs_capacity": 4}), "dropped": ("long", {})}


class _Warnings:
    """The warnings both packages' loggers emit while open."""

    def __enter__(self):
        import logging

        self.messages, handler = [], logging.Handler()
        handler.emit = lambda r: self.messages.append(r.getMessage())
        self.loggers = [logging.getLogger(n) for n in ("locust_tpu", "locust_tpu_torch")]
        self.handler = handler
        for lg in self.loggers:
            lg.addHandler(handler)
        return self

    def __exit__(self, *exc):
        for lg in self.loggers:
            lg.removeHandler(self.handler)


def run_index(apps, pkg, mesh, name: str) -> dict:
    """One INDEX scenario: the index ({word hex: doc ids}) or the error,
    the warnings logged, and for ``oracle`` ``run_stream`` over chunks of
    one round."""
    kind, kw = INDEX[name]
    docs = index_docs(kind)
    cfg = pkg.EngineConfig(**APP_CFG)
    lines, ids = list(docs.values()), np.asarray(list(docs), np.int32)
    out = {}
    with _Warnings() as w:
        try:
            got = apps.build_inverted_index_mesh(lines, ids, mesh, cfg, **kw)
            out["index"] = {k.hex(): v for k, v in sorted(got.items())}
        except ValueError as e:
            out["error"] = str(e)
    out["warnings"] = w.messages
    if name == "oracle":
        idx = apps.DistributedInvertedIndex(mesh, cfg, **kw)
        rows = pkg.core.bytes_ops.strings_to_rows(lines, cfg.line_width)
        lpr = idx.lines_per_round
        got = idx.run_stream((rows[i:i + lpr], ids[i:i + lpr])
                             for i in range(0, rows.shape[0], lpr))
        out["stream"] = {k.hex(): v for k, v in sorted(got.items())}
    return out


def sort_words(kind: str) -> list[bytes]:
    if kind in ("random", "padding"):
        rng = np.random.default_rng(7 if kind == "random" else 3)
        return [bytes(rng.integers(97, 123, size=rng.integers(1, 12)).astype(np.uint8))
                for _ in range(4000 if kind == "random" else 1000)]
    if kind == "dups":
        return [b"same"] * 300 + [b"other"] * 200 + [b"zz", b"aa"] * 50
    if kind == "budget":
        return [b"same"] * 512
    return [b"delta", b"alpha", b"echo", b"charlie", b"bravo", b"foxtrot"]


# name -> (entry point, words, kwargs): ``strings`` is sort_strings,
# ``rows`` DistributedSort.sort_rows, ``overflow`` the overflow of
# sort_rows at each skew factor sort_strings' retries take.
SORT = {
    "random": ("strings", "random", {}),
    "dups": ("strings", "dups", {}),
    "dups_retry": ("strings", "dups", {"skew_factor": 0.5}),
    "budget": ("strings", "budget", {"max_retries": 0, "skew_factor": 0.25}),
    "values": ("rows", "values", {"rows_per_device": 8}),
    "padding": ("rows", "padding", {"rows_per_device": 1024}),
    "dups_overflow": ("overflow", "dups", {}),
}


def run_sort(apps, pkg, mesh, name: str) -> dict:
    entry, kind, kw = SORT[name]
    words = sort_words(kind)
    cfg = pkg.EngineConfig(**APP_CFG)
    if entry == "strings":
        try:
            return {"keys": [k.hex() for k in apps.sort_strings(words, mesh, cfg, **kw)]}
        except ValueError as e:
            return {"error": str(e)}
    rows = pkg.core.bytes_ops.strings_to_rows(words, cfg.key_width)
    if entry == "rows":
        res = apps.DistributedSort(mesh, cfg, **kw).sort_rows(rows)
        return {"pairs": [[k.hex(), v] for k, v in res.to_host_sorted()],
                "overflow": res.overflow}
    n_dev = mesh.shape["data"]
    rpd = (-(-len(words) // n_dev) + 7) // 8 * 8  # sort_strings' rows per device
    return {"overflow": [apps.DistributedSort(mesh, cfg, rpd, skew_factor=s).sort_rows(
        rows).overflow for s in (0.25, 0.5, 1.0, 2.0, 4.0)]}


def sorted_runs(pairs) -> tuple[list, dict]:
    """A sort's keys in order, and each run of equal keys' values as a
    multiset (the JAX package's sorts are not stable, the port's are)."""
    import collections

    by_key = collections.defaultdict(collections.Counter)
    for k, v in pairs:
        by_key[k][v] += 1
    return [k for k, _ in pairs], dict(by_key)


RECORD_BYTES, KEY_BYTES = 100, 10
# kind -> (records per rank, rows_per_device) of the record sort's world
# scenarios; a rank's records are ``terasort_input(kind, n, rank)``.
TERASORT = {"gensort": (1500, 1504), "planted": (1200, 1504), "binary": (900, 1024),
            "padded": (40, 1024)}


def terasort_input(kind: str, n: int, seed: int) -> np.ndarray:
    """``[n, 100]`` uint8 records: ``gensort`` (uniform printable 10-byte
    keys), ``planted`` (keys sharing 8- and 9-byte prefixes, and exact
    duplicates), ``binary`` (key bytes over 0..255, so unsigned order
    differs from signed), ``padded`` (as gensort, a few records), ``hot``
    (three records in five share one key) or ``one_key`` (every record
    the same key).  Bytes 12-19 hold the record's number, so input order
    is visible."""
    rng = np.random.default_rng([seed, len(kind)])
    rec = rng.integers(0x20, 0x7F, (n, RECORD_BYTES), dtype=np.uint8)
    if kind == "hot":
        rec[np.arange(n) % 5 < 3, :KEY_BYTES] = np.frombuffer(b"HotKey!!!!", np.uint8)
    if kind == "one_key":
        rec[:, :KEY_BYTES] = np.frombuffer(b"SameKey!!!", np.uint8)
    if kind == "binary":
        rec[:, :KEY_BYTES] = rng.integers(0, 256, (n, KEY_BYTES), dtype=np.uint8)
        rec[: n // 3, :2] = rng.choice(np.array([0x00, 0x7F, 0x80, 0xFF], np.uint8), (n // 3, 2))
    if kind == "planted":
        i = np.arange(n)
        rec[i % 4 == 1, :8] = np.frombuffer(b"TeraSort", np.uint8)
        rec[i % 4 == 1, 8:KEY_BYTES] = rng.choice(np.frombuffer(b" !~", np.uint8),
                                                  ((i % 4 == 1).sum(), 2))
        rec[i % 4 == 2, :9] = np.frombuffer(b"TeraSort!", np.uint8)
        rec[i % 4 == 2, 9] = rng.choice(np.frombuffer(b" !~", np.uint8), (i % 4 == 2).sum())
        dups = np.frombuffer(b"duplicate0duplicate1TeraSort!!", np.uint8).reshape(3, KEY_BYTES)
        rec[i % 4 == 3, :KEY_BYTES] = dups[rng.integers(0, 3, (i % 4 == 3).sum())]
    rec[:, 12:20] = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    return rec


def run_terasort(mesh, kind: str) -> dict:
    """Every rank's ``sort_records`` output, in rank order, and the
    overflow; rank ``r`` sorts ``terasort_input(kind, n, r)``."""
    import torch.distributed as dist

    from locust_tpu_torch.apps.sample_sort import DistributedSort
    from locust_tpu_torch.config import EngineConfig

    n, rows_per_device = TERASORT[kind]
    got, overflow = DistributedSort(mesh, EngineConfig(key_width=12), rows_per_device).sort_records(
        terasort_input(kind, n, mesh.rank), KEY_BYTES)
    parts = [None] * mesh.size
    dist.all_gather_object(parts, got.cpu().numpy())
    return {"records": np.concatenate(parts), "counts": np.array([p.shape[0] for p in parts]),
            "overflow": np.array(overflow)}


# The record sort's world of 4: "planted" records, 3,000 a rank (rows per
# device the same), sorted with each rank's tracer on.  The planted
# duplicates are the same keys on every rank, so their runs span ranks.
TERASORT4 = (3000, 3000)


def run_terasort4(mesh) -> dict:
    """``run_terasort``'s world-of-4 case, traced: every rank's output in
    rank order, the overflow, and each rank's span names and all-to-all
    calls and bytes (``mesh.all_to_all_*``)."""
    import torch.distributed as dist

    from locust_tpu_torch import obs
    from locust_tpu_torch.apps.sample_sort import DistributedSort
    from locust_tpu_torch.config import EngineConfig

    n, rows_per_device = TERASORT4
    tracer = obs.enable(process=f"rank{mesh.rank}")
    try:
        got, overflow = DistributedSort(mesh, EngineConfig(key_width=12),
                                        rows_per_device).sort_records(
            terasort_input("planted", n, mesh.rank), KEY_BYTES)
        counters = obs.metrics_snapshot()["counters"]
        own = (got.cpu().numpy(), counters.get("mesh.all_to_all_calls", 0),
               counters.get("mesh.all_to_all_bytes", 0), [s[0] for s in tracer.spans()])
    finally:
        obs.disable()
    parts = [None] * mesh.size
    dist.all_gather_object(parts, own)
    return {"records": np.concatenate([p[0] for p in parts]),
            "counts": np.array([p[0].shape[0] for p in parts]),
            "overflow": np.array(overflow), "a2a_calls": np.array([p[1] for p in parts]),
            "a2a_bytes": np.array([p[2] for p in parts]),
            "spans": np.array([",".join(p[3]) for p in parts])}


# The record sort's other world-of-4 cases: name -> (kind, records on each
# rank, rows_per_device, skew_factor).  ``skewed`` overflows the hot key's
# bin on every rank; ``empty_rank``'s rank 2 sends nothing; ``one_key``
# sends every record to rank 3, each bin at its capacity, so ranks 0-2
# receive nothing and rank 3's ties come from every rank.
TERASORT4_CASES = {
    "skewed": ("hot", (600, 600, 600, 600), 600, 1.0),
    "empty_rank": ("gensort", (500, 500, 0, 500), 512, 2.0),
    "one_key": ("one_key", (300, 300, 300, 300), 300, 4.0),
}


def run_terasort4_case(mesh, name: str) -> dict:
    """One ``TERASORT4_CASES`` sort, traced: every rank's output in rank
    order, the overflow, the splitters (the same on every rank) and each
    rank's rise of ``sample_sort.slots_skipped``, ``.host_syncs`` and the
    mesh's all-to-all calls and bytes."""
    import torch.distributed as dist

    from locust_tpu_torch import obs
    from locust_tpu_torch.apps.sample_sort import DistributedSort
    from locust_tpu_torch.config import EngineConfig

    kind, counts, rows_per_device, skew = TERASORT4_CASES[name]
    sorter = DistributedSort(mesh, EngineConfig(key_width=12), rows_per_device,
                             skew_factor=skew)
    splitters, real = [], sorter._splitters

    def spy(lanes, valid):
        splitters.append(real(lanes, valid))
        return splitters[-1]

    sorter._splitters = spy
    obs.enable(process=f"rank{mesh.rank}")
    try:
        got, overflow = sorter.sort_records(
            terasort_input(kind, counts[mesh.rank], mesh.rank), KEY_BYTES)
        c = obs.metrics_snapshot()["counters"]
        own = (got.cpu().numpy(), [c.get(k, 0) for k in (
            "sample_sort.slots_skipped", "sample_sort.host_syncs", "mesh.all_to_all_calls",
            "mesh.all_to_all_bytes")])
    finally:
        obs.disable()
    parts = [None] * mesh.size
    dist.all_gather_object(parts, own)
    return {f"{name}_records": np.concatenate([p[0] for p in parts]),
            f"{name}_counts": np.array([p[0].shape[0] for p in parts]),
            f"{name}_overflow": np.array(overflow),
            f"{name}_splitters": splitters[0].cpu().numpy(),
            f"{name}_cap": np.array(sorter.bin_capacity),
            f"{name}_counters": np.array([p[1] for p in parts])}


# The split-size all-to-all in a world of 4: A2AV_SIZES[s][d] rows go from
# rank s to rank d.  Rank 0 sends rank 1 nothing, rank 3 sends rank 2
# nothing, rank 1 sends nothing at all and receives nothing.
A2AV_SIZES = ((3, 0, 5, 1), (0, 0, 0, 0), (2, 0, 7, 4), (1, 0, 0, 6))


def a2av_block(sender: int, dest: int) -> np.ndarray:
    """The ``[A2AV_SIZES[sender][dest], 3]`` int32 rows ``(sender, dest,
    j)`` that rank ``sender`` sends rank ``dest``."""
    rows = A2AV_SIZES[sender][dest]
    return np.stack([np.full(rows, sender), np.full(rows, dest), np.arange(rows)],
                    axis=1).astype(np.int32)


def run_a2av(mesh) -> dict:
    """``Mesh.all_to_all_v`` of the ``A2AV_SIZES`` blocks along the world's
    ``data`` axis and along the ``slice`` axis of a ``[4, 1]`` mesh, and
    of one block along that mesh's ``data`` axis of one rank (the
    identity); each rank's result and its rise of the mesh's all-to-all
    calls and bytes after each."""
    import torch
    import torch.distributed as dist

    from locust_tpu_torch import obs
    from locust_tpu_torch.parallel import make_mesh_2d

    r = mesh.rank
    blocks = [torch.from_numpy(a2av_block(r, d)) for d in range(mesh.size)]
    recv = [A2AV_SIZES[s][r] for s in range(mesh.size)]
    mesh2 = make_mesh_2d(4, 1, device="cpu")
    obs.enable(process=f"rank{r}")
    seen = []

    def counters():
        c = obs.metrics_snapshot()["counters"]
        seen.append([c.get("mesh.all_to_all_calls", 0), c.get("mesh.all_to_all_bytes", 0)])

    try:
        got = mesh.all_to_all_v(blocks, recv, "data")
        counters()
        along = mesh2.all_to_all_v(blocks, recv, "slice")
        counters()
        identity = mesh2.all_to_all_v(blocks[:1], recv[:1], "data") is blocks[0]
        counters()
    finally:
        obs.disable()
    parts = [None] * mesh.size
    dist.all_gather_object(parts, (got.numpy(), along.numpy(), identity, seen))
    return {"got": np.concatenate([p[0] for p in parts]),
            "along": np.concatenate([p[1] for p in parts]),
            "counts": np.array([p[0].shape[0] for p in parts]),
            "along_counts": np.array([p[1].shape[0] for p in parts]),
            "identity": np.array([p[2] for p in parts]),
            "counters": np.array([p[3] for p in parts])}


def _suite_apps(pkg, mesh, out: dict, tables: dict, pagerank=(), index=(), sort=(),
                terasort=(), terasort4=False) -> None:
    from locust_tpu_torch import apps

    for name in pagerank:
        tables[name] = {"ranks": run_pagerank(apps, mesh, name)}
    for name in index:
        out[f"index_{name}"] = run_index(apps, pkg, mesh, name)
    for name in sort:
        out[f"sort_{name}"] = run_sort(apps, pkg, mesh, name)
    for name in terasort:
        tables[f"terasort_{name}"] = run_terasort(mesh, name)
    if terasort4:
        tables["terasort4"] = run_terasort4(mesh)
        tables["terasort4_cases"] = {k: v for name in TERASORT4_CASES
                                     for k, v in run_terasort4_case(mesh, name).items()}
        tables["a2av"] = run_a2av(mesh)


APP_SUITES = {
    "apps_pagerank": dict(pagerank=tuple(PAGERANK)),
    "apps_index": dict(index=tuple(INDEX)),
    "apps_sort": dict(sort=tuple(SORT)),
    "apps_terasort": dict(terasort=tuple(TERASORT)),
    "apps_terasort4": dict(terasort4=True),
    "apps_world4": dict(pagerank=("sharded_1003", "sharded_dangling", "distributed_zipf"),
                        index=("oracle", "skew"),
                        sort=("random", "dups", "dups_retry", "dups_overflow")),
}


def worker(pkg_name: str, coordinator: str, n: int, pid: int, outdir: str, suite: str) -> int:
    out, tables = {}, {}
    if pkg_name == "jax":
        import jax

        from locust_tpu import parallel
        from locust_tpu.parallel.mesh import initialize_multihost

        initialize_multihost(coordinator, n, pid)
        pkg = jax_pkg()
        from jax.experimental import multihost_utils

        rank = jax.process_index()
        _suite_resume(pkg, parallel, parallel.make_mesh(), out, outdir, "jax", "torch",
                      lambda: multihost_utils.sync_global_devices("crashed"), rank)
    else:
        import torch.distributed as dist

        from locust_tpu_torch import parallel
        from locust_tpu_torch.parallel import mesh as mesh_mod

        mesh_mod.initialize_multihost(coordinator, n, pid, device="cpu")
        pkg = _torch_pkg()
        rank = dist.get_rank()
        if suite == "flat":
            _suite_flat(pkg, parallel, out, tables, outdir)
        elif suite == "hier_modes":
            for name in HIER_MODES:
                out[name], tables[name] = run_hier(
                    pkg, parallel, lambda s, d: parallel.make_mesh_2d(s, d, device="cpu"), name)
        elif suite == "hier":
            _suite_hier(pkg, parallel, out, tables, outdir)
        elif suite in APP_SUITES:
            _suite_apps(pkg, parallel.make_mesh(device="cpu"), out, tables, **APP_SUITES[suite])
        else:
            _suite_resume(pkg, parallel, parallel.make_mesh(device="cpu"), out, outdir,
                          "torch", "jax", dist.barrier, rank)
        out["comm"] = mesh_mod.COMM
        mesh_mod.shutdown()
    if rank == 0:
        for name, t in tables.items():
            np.savez(os.path.join(outdir, f"{name}.npz"), **t)
        with open(os.path.join(outdir, f"{pkg_name}.json.tmp"), "w") as f:
            json.dump(out, f)
        os.replace(os.path.join(outdir, f"{pkg_name}.json.tmp"),
                   os.path.join(outdir, f"{pkg_name}.json"))
    return 0


def start_world(pkg_name: str, n: int, outdir: str, suite: str) -> list:
    """Start a world of ``n`` processes of this rig (JAX: one CPU device
    each; one compute thread each, since the ranks share the host's
    cores); their output goes to ``outdir/<pkg>.<pid>.out|err``."""
    from locust_tpu_torch.parallel.mesh import free_port

    os.makedirs(outdir, exist_ok=True)
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", MASTER_ADDR="127.0.0.1",
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=1 "
                         "--xla_cpu_multi_thread_eigen=false")
    procs = []
    for pid in range(n):
        with open(os.path.join(outdir, f"{pkg_name}.{pid}.out"), "wb") as o, \
                open(os.path.join(outdir, f"{pkg_name}.{pid}.err"), "wb") as e:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), pkg_name, coordinator, str(n),
                 str(pid), outdir, suite], env=env, stdout=o, stderr=e))
    return procs


def finish_world(procs: list, outdir: str, pkg_name: str, timeout: float = 240.0) -> dict:
    """Wait for the world; every rank must exit 0.  Returns rank 0's JSON."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(outdir, f"{pkg_name}.{pid}.err"), "rb") as f:
                err = f.read()[-3000:].decode(errors="replace")
            raise AssertionError(f"{pkg_name} rank {pid} exited {p.returncode}:\n{err}")
    with open(os.path.join(outdir, f"{pkg_name}.json")) as f:
        return json.load(f)


if __name__ == "__main__":
    a = sys.argv[1:]
    raise SystemExit(worker(a[0], a[1], int(a[2]), int(a[3]), a[4], a[5]))
