#!/usr/bin/env python3
"""Kernels A and C and PageRank's gather-add of the PyTorch/CUDA port, one
checkout against another, on one NVIDIA GPU.

    python3 chip_kernel_ab.py BASE_ROOT NEW_ROOT

Each ROOT is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Runs base, new, new, base, each in its own process that imports
``locust_tpu_torch`` from its ROOT, builds the three kernels there and
times ``tokenize_block_kernel`` and ``fused_block_preagg`` at the main
path's shapes (the CLI's defaults: a 4,096-line block of 128-byte rows of
``data/sample_corpus.txt``, 20 emits, 32-byte keys), and ``gather_add`` at
web-Google's scale (``chip_smoke.synthetic_web_graph``: 875,713 nodes,
5,105,039 edges), on the same graph with ``dst`` redrawn uniformly (seed
21), on its rows of more than 1,024 in-edges alone, at a world of 2's
send-slot and receive shapes over it (rank 0 of ``ShardedPageRank``'s
two sums, sources and rows two index spaces; the receive sum
unweighted) and on a Graph500 Kronecker graph of SCALE 24 made on the
card (``benchmark/graph.py`` with ``benchmark/configs/
pagerank-graph500-s24.json``'s graph, seed 2000000024: 16,777,216 nodes,
536,870,912 arcs), each through its checkout's own groupings and held
bit for bit against the CPU's ``index_add_`` (which adds in edge order):
wall time (CUDA events around 200 back-to-back calls, host dispatch
included) and, from ``torch.profiler``, the device ops per call, their
device time and the kernel's own; for the gather-add also the grouping's
build time, ``index_add_``'s device time (gather, multiply,
scatter-add) and, at the web graph, ``pagerank``'s iterations per second
(20 iterations, median of 3).  Prints one JSON line per run, the card's name and power
limit, and last a JSON line with each checkout's mean over its two runs.
Imports nothing of JAX.

The range shuffle's partition (group ``partition``) runs at
``ts-huge-resident``'s shapes: 80,000,000 rows of 3 key lanes, values and
100-byte records (random, seed 24), into 1 bin (every row's bucket 0)
and into 4 (uniform buckets), with ``DistributedSort``'s bin capacity.
Each checkout runs what its ``sample_sort.partition`` span runs after
the bucket: a checkout with ``shuffle.partition_packed`` the kernel
(held slot for slot, and the records byte for byte in every filled slot,
against the plain version ``ops/kernels/partition._plain`` on the card),
one without it ``partition_to_bins``, the exchange's ``cat`` and the
records' gather by the binned values.  Reported: wall time (CUDA events
over 10 calls), the device ops per call and their device time (every op
``torch.profiler`` records over 5 calls), the kernel's own (its
histogram, scan and scatter, each also alone) and its bytes bound at 3.35 TB/s
(``utils/roofline.partition_min_bytes``, from this script's checkout).

    python3 chip_kernel_ab.py BASE_ROOT NEW_ROOT [GROUP ...]

runs only the named groups (``kernels``: A and C; ``pagerank``;
``partition``), all three by default.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

KERNELS = {"tokenize": "tokenize_kernel", "fused_fold": "fused_preagg_kernel",
           "pagerank_web": "gather_add_kernel", "pagerank_uniform": "gather_add_kernel",
           "pagerank_long_rows": "gather_add_kernel", "pagerank_send_w2": "gather_add_kernel",
           "pagerank_receive_w2": "gather_add_kernel", "pagerank_g500s24": "gather_add_kernel",
           "partition_b1": "partition_", "partition_b4": "partition_"}
GROUPS = ("kernels", "pagerank", "partition")
# The SCALE-24 graph's seed.
G500_SEED = 2_000_000_024
# ts-huge-resident's rows, key lanes and record bytes.
PARTITION_SHAPE = (80_000_000, 3, 100)


def _child(root: str, groups: list[str]) -> dict:
    import importlib.util

    import numpy as np
    import torch

    # The timing helpers of the chip_smoke.py beside this script; the
    # package under test from ROOT.
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    from locust_tpu_torch import _build
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.core import bytes_ops
    from locust_tpu_torch.ops.kernels.fused_fold import fused_block_preagg
    from locust_tpu_torch.ops.kernels.tokenize import tokenize_block_kernel

    _build.build(tuple(k for k in ("tokenize", "fused_fold", "pagerank", "partition")
                       if k in _build.KERNEL_SOURCES))
    out = {"root": root}
    if "partition" in groups:
        out.update(_partition(smoke, torch))
    if "pagerank" in groups:
        out.update(_pagerank(smoke, torch, np))
    if "kernels" not in groups:
        return out
    cfg = EngineConfig(sort_mode="fused")
    E, K, W, BL = cfg.emits_per_line, cfg.key_width, cfg.line_width, cfg.block_lines
    with open(os.path.join(root, "data", "sample_corpus.txt"), "rb") as f:
        base = f.read().splitlines()
    rows = bytes_ops.strings_to_rows((base * (BL // len(base) + 1))[:BL], W)
    x = torch.from_numpy(np.ascontiguousarray(rows)).cuda()
    calls = {"tokenize": lambda: tokenize_block_kernel(x, E, K),
             "fused_fold": lambda: fused_block_preagg(x, cfg)}
    for name, fn in calls.items():
        out[name] = {"wall_ms": smoke.cuda_ms(torch, fn, reps=200, warmup=50)}
    for name, fn in calls.items():
        ops, total, own = smoke.call_profile(torch, fn, KERNELS[name])
        out[name].update(device_ops_per_call=ops, device_ms=total, kernel_device_ms=own)
    return out


def _partition(smoke, torch) -> dict:
    """The partition at ``ts-huge-resident``'s shapes into 1 and 4 bins,
    through the checkout's own path (module docstring)."""
    from locust_tpu_torch.apps.sample_sort import _round_up
    from locust_tpu_torch.core.kv import KVBatch
    from locust_tpu_torch.parallel import shuffle

    n, n_lanes, width = PARTITION_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    words = torch.randint(-2**31, 2**31, (n, width // 4), dtype=torch.int32, device=dev,
                          generator=gen)
    kv = KVBatch(torch.randint(-2**31, 2**31, (n, n_lanes), dtype=torch.int32, device=dev,
                               generator=gen),
                 torch.arange(n, dtype=torch.int32, device=dev),
                 torch.ones(n, dtype=torch.bool, device=dev))
    kernel = hasattr(shuffle, "partition_packed")
    out = {}
    for n_bins in (1, 4):
        cap = min(shuffle.sized_bins(n, n_bins, 2.0), _round_up(n, 8))
        bucket = (torch.zeros(n, dtype=torch.int64, device=dev) if n_bins == 1 else
                  torch.randint(0, n_bins, (n,), dtype=torch.int64, device=dev, generator=gen))
        if kernel:
            def fn():
                return shuffle.partition_packed(kv, n_bins, cap, bucket=bucket, payload=words)

            _check_partition(torch, fn(), kv, bucket, words, n_bins, cap)
        else:
            def fn():
                lanes, vals, ok, overflow, _ = shuffle.partition_to_bins(kv, n_bins, cap,
                                                                         bucket=bucket)
                packed = torch.cat([lanes, vals[..., None], ok[..., None].to(torch.int32)], -1)
                return packed, overflow, words[vals.long()]
        torch.cuda.synchronize()
        wall = smoke.cuda_ms(torch, fn, reps=10, warmup=2)
        # Every device op of 5 calls (the base's hidden reads rule out a
        # copy as the marker that call_profile takes).
        reps = 5

        def calls():
            for _ in range(reps):
                fn()  # each call's outputs freed before the next: 19 GB at 4 bins

        events = smoke.device_events(torch, calls)
        split = {}
        for e in events:
            if KERNELS["partition_b1"] in e.name:
                name = e.name.split("partition_")[1].split("_kernel")[0]
                split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
        out[f"partition_b{n_bins}"] = {
            "wall_ms": wall, "device_ops_per_call": len(events) / reps,
            "device_ms": sum(e.time_range.elapsed_us() for e in events) / reps / 1e3,
            "kernel_device_ms": sum(split.values()) if kernel else None,
            "kernel_split_ms": split or None, "rows": n, "key_lanes": n_lanes,
            "record_bytes": width, "n_bins": n_bins, "bin_capacity": cap}
        del bucket
    return out


def _check_partition(torch, got, kv, bucket, words, n_bins, cap) -> None:
    """The kernel's bins, overflow and filled slots' records against the
    plain version's on the card."""
    from locust_tpu_torch.ops.kernels import partition

    bins, overflow, _, binned = got
    rows, want_overflow, want_binned = partition._plain(bucket, kv.valid, kv.key_lanes,
                                                        kv.values, n_bins, cap, 0, words)[:3]
    if not torch.equal(bins.reshape(-1, bins.shape[-1]), rows) or int(overflow) != int(
            want_overflow):
        raise AssertionError(f"partition into {n_bins} bins: the kernel's bins differ "
                             "from the plain version's")
    del rows
    filled = (bins[..., -1] != 0)[..., None]
    if bool(((binned != want_binned) & filled).any()):
        raise AssertionError(f"partition into {n_bins} bins: the kernel's records differ "
                             "from the plain version's")


def _gather_case(smoke, torch, name, grouping, ranks, inv_deg, init, want, edges) -> dict:
    """One gather-add shape: the kernel's totals against ``want`` (the
    CPU's, on the card), then its wall time, its device ops and their
    time, its own, and ``index_add_``'s device time over the same
    ``edges`` (``(src, dst)`` on the card)."""
    from locust_tpu_torch.ops.kernels.pagerank import gather_add

    n = grouping.schedule.shape[0]

    def kernel():
        return gather_add(init, *grouping, ranks, inv_deg)

    if not torch.equal(kernel(), want):
        raise AssertionError(f"{name}: the gather-add differs from the CPU's index_add_")
    wall = smoke.cuda_ms(torch, kernel, reps=200, warmup=20)
    ops, total, own = smoke.call_profile(torch, kernel, KERNELS[name])
    s_t, d_t = edges
    lib = smoke.device_ms(torch, lambda: init.expand(n).clone().index_add_(
        0, d_t, ranks[s_t] * inv_deg[s_t] if inv_deg is not None else ranks[s_t]))
    return {"wall_ms": wall, "device_ops_per_call": ops, "device_ms": total,
            "kernel_device_ms": own, "index_add_device_ms": lib,
            "max_in_degree": int((grouping.offsets[1] - grouping.offsets[0]).item()) if n else 0}


def _pagerank(smoke, torch, np) -> dict:
    """The gather-add at web-Google's scale, with uniform destinations,
    on the long rows, at a world of 2's slot shapes and at SCALE 24."""
    import time

    from locust_tpu_torch.apps.pagerank import (ShardedPageRank, pagerank, pagerank_grouping,
                                                pagerank_prep)
    from locust_tpu_torch.ops.kernels.pagerank import gather_add
    from locust_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda")
    n, src, dst = smoke.synthetic_web_graph()
    in_deg = np.bincount(dst, minlength=n)
    graphs = {"pagerank_web": (src, dst),
              "pagerank_uniform": (src, np.random.default_rng(21).integers(0, n, len(src))),
              "pagerank_long_rows": (src[in_deg[dst] > 1024], dst[in_deg[dst] > 1024])}
    inv_deg, _ = pagerank_prep(src, n, dev)
    ranks = torch.from_numpy(np.random.default_rng(4).random(n).astype(np.float32) / n).to(dev)
    init = torch.tensor(np.float32(0.3) / np.float32(n), device=dev)
    contrib = ranks.cpu() * inv_deg.cpu()
    out = {}
    for name, (s, d) in graphs.items():
        s_t, d_t = torch.from_numpy(s).to(dev), torch.from_numpy(d).to(dev)
        # The CPU's index_add_ adds in edge order: the bits the card must give.
        want = init.cpu().expand(n).clone().index_add_(
            0, torch.from_numpy(d), contrib[torch.from_numpy(s)]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grouping = pagerank_grouping(s_t, d_t, n, dev)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        out[name] = _gather_case(smoke, torch, name, grouping, ranks, inv_deg, init, want,
                                 (s_t, d_t))
        out[name]["grouping_build_ms"] = build_ms
    # A world of 2's two sums on rank 0: the send sum (local nodes into
    # send slots) and the unweighted receive sum (received slots into
    # local nodes), against the CPU wrapper over the same grouping.
    sp = ShardedPageRank(Mesh(0, 2, ("data",), (2,), {"data": None}, dev, "gloo"), n)
    plan = sp._build_plan(src, dst)
    send_g, recv_g = sp.groupings(plan)
    rng = np.random.default_rng(5)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for name, g, r, i in (
            ("pagerank_send_w2", send_g, rng.random(sp.npd).astype(np.float32) / n,
             (1.0 / rng.integers(1, 9, sp.npd)).astype(np.float32)),
            ("pagerank_receive_w2", recv_g,
             rng.random(2 * plan["cap"]).astype(np.float32) / n, None)):
        r = torch.from_numpy(r)
        i = None if i is None else torch.from_numpy(i)
        want = gather_add(zero.cpu(), *(t.cpu() for t in g[:3]), g.warp_rows, r, i).to(dev)
        d_t = torch.repeat_interleave(g.schedule.long(), (g.offsets[1:] - g.offsets[:-1]).long())
        out[name] = _gather_case(smoke, torch, name, g, r.to(dev),
                                 None if i is None else i.to(dev), zero, want,
                                 (g.src_by_dst.long(), d_t))
    out.update(_pagerank_g500(smoke, torch, np))
    # End to end: ``pagerank``'s 20 iterations at the web graph, median of 3.
    pagerank(src, dst, n, 1, device=dev)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        pagerank(src, dst, n, 20, device=dev)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    out["pagerank_web"]["iters_per_s"] = 20 / float(np.median(runs))
    return out


def _pagerank_g500(smoke, torch, np) -> dict:
    """The gather-add over the benchmark's SCALE-24 Kronecker graph, its
    weighted sum as ``pagerank_step`` calls it, against the CPU's
    ``index_add_``."""
    from locust_tpu_torch.apps.pagerank import pagerank_grouping, pagerank_prep

    sys.path.append(os.path.dirname(os.path.abspath(__file__)))
    from benchmark import graph

    with open(os.path.join(os.path.dirname(graph.__file__), "configs",
                           "pagerank-graph500-s24.json")) as f:
        cfg = json.load(f)["graph"]
    dev = torch.device("cuda")
    n = 1 << cfg["scale"]
    src, dst = graph.kronecker_arcs(cfg, G500_SEED, "cuda")
    inv_deg, _ = pagerank_prep(src, n, dev)
    grouping = pagerank_grouping(src, dst, n, dev)
    ranks = torch.from_numpy(np.random.default_rng(24).random(n).astype(np.float32) / n).to(dev)
    init = torch.tensor(np.float32(0.3) / np.float32(n), device=dev)
    s_cpu, d_cpu = src.cpu(), dst.cpu()
    want = init.cpu().expand(n).clone().index_add_(
        0, d_cpu, (ranks.cpu() * inv_deg.cpu())[s_cpu]).to(dev)
    del s_cpu, d_cpu
    row = _gather_case(smoke, torch, "pagerank_g500s24", grouping, ranks, inv_deg, init,
                       want, (src, dst))
    row["warp_rows"] = grouping.warp_rows
    return {"pagerank_g500s24": row}


def _partition_bound(row: dict) -> None:
    """The partition's bytes bound at the row's shapes, and the kernel's
    own time's share of it."""
    from locust_tpu_torch.utils.roofline import partition_min_bytes

    row["bound_ms"] = partition_min_bytes(
        row["rows"], row["key_lanes"], row["n_bins"], row["bin_capacity"],
        payload_bytes=row["record_bytes"]) / 3.35e9
    own = row["kernel_device_ms"]
    row["roofline_pct"] = None if not own else 100 * row["bound_ms"] / own


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        print(json.dumps(_child(os.path.abspath(argv[1]), argv[2:])), flush=True)
        return 0
    groups = argv[2:] or list(GROUPS)
    if len(argv) < 2 or not set(groups) <= set(GROUPS):
        raise SystemExit(__doc__)
    roots = {"base": os.path.abspath(argv[0]), "new": os.path.abspath(argv[1])}
    runs = {"base": [], "new": []}
    for which in ("base", "new", "new", "base"):
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": roots[which]}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", roots[which],
                               *groups], env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{which} run failed:\n{proc.stdout}\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for k in res:
            if k.startswith("partition_"):
                _partition_bound(res[k])
        runs[which].append(res)
        print(json.dumps({"run": which, **res}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    mean = {which: {k: {m: None if any(r[k][m] is None for r in rs)
                        else sum(r[k][m] for r in rs) / len(rs) for m in rs[0][k]
                        if not isinstance(rs[0][k][m], dict)}
                    for k in KERNELS if k in rs[0]} for which, rs in runs.items()}
    print(json.dumps({"card": smi, "mean_of_two_runs": mean}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
