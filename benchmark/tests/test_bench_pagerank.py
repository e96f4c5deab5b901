"""The PageRank cell on the CPU at a tiny scale: the Kronecker generator,
a clean run read ``correct: true``, planted faults read ``correct:
false``, and the cell's five per-layer readers on a traced record.

Each run goes through the harness's driver as a run on the card would,
without the harness's look for a card, with the configuration's graph
cut to SCALE 10 or 16 (2^10 or 2^16 nodes) and the configuration's own
limits."""

import copy
import importlib
import math
import tempfile

import numpy as np
import pytest
import torch

from benchmark import graph, harness
from benchmark.frozen import roofline

torch.set_num_threads(1)

CELL = "pr-g500s24-resident"
METRICS = ["pr_grouping_ms", "pr_iter_host_us", "pr_device_ops_per_iter",
           "gather_add_roofline", "device_idle_pct.pagerank"]


def run_tiny(scale: int = 10, seed: int = 2**33 + 5, trace: bool = False):
    """``(result line, driver output)`` of one run at ``scale`` on the CPU."""
    man = harness.manifest()
    cell, config, traffic = harness.resolve(man, CELL)
    config = copy.deepcopy(config)
    config["graph"]["scale"] = scale
    with tempfile.TemporaryDirectory() as wd:
        ctx = harness.Context(workload=CELL, cell=cell, config=config, traffic=traffic,
                              seed=seed, seconds=0.5, trace=trace, device="cpu", workdir=wd)
        out = harness.run_cell(ctx)
    return harness.result_line(man, ctx, out), out


def graph_of(scale: int, seed: int):
    g = copy.deepcopy(harness.load_config("pagerank-graph500-s24")["graph"])
    g["scale"] = scale
    return graph.kronecker_arcs(g, seed, "cpu")


@pytest.mark.parametrize("seed", [0, 2**31 + 3, -(2**40) - 1])
def test_generator_is_seeded_and_undirected(seed):
    scale = 8
    src, dst = graph_of(scale, seed)
    again = graph_of(scale, seed)
    other = graph_of(scale, seed + 1)
    m = 16 << scale
    assert src.dtype == dst.dtype == torch.int64 and src.shape == dst.shape == (2 * m,)
    assert torch.equal(src, again[0]) and torch.equal(dst, again[1])
    assert not torch.equal(src, other[0])
    assert int(src.min()) >= 0 and int(src.max()) < 1 << scale
    # Both arcs of every edge: the u -> v arcs, then the v -> u arcs.
    assert torch.equal(src[:m], dst[m:]) and torch.equal(dst[:m], src[m:])
    facts = graph.facts(src, dst, 1 << scale)
    assert facts["arcs"] == 2 * m and facts["max_in_degree"] > 64 and facts["warp_rows"] > 0
    assert 0 < facts["isolated"] < 1 << scale


def test_generator_follows_the_initiator():
    """The heaviest vertex is the one labelled all zeros before the
    permutation: an endpoint lands there with odds (A + B)^scale (the
    source) and (A + C)^scale (the destination), 0.76^4 each here."""
    u, v = graph.kronecker_edges(4, 4096, (0.57, 0.19, 0.19, 0.05), 9, "cpu")
    deg = torch.bincount(torch.cat([u, v]), minlength=16).double()
    want = 2 * (4096 << 4) * 0.76**4  # 43,728 of the 131,072 endpoints
    assert abs(float(deg.max()) - want) / want < 0.05


def test_clean_tiny_cell_is_correct():
    line, out = run_tiny()
    assert line["correct"], line["checks"]
    assert line["checks"]["nonfinite_ranks"] == {"value": 0, "limit": 0}
    assert out["record"]["graph"]["arcs"] == 2 * 16 << 10
    assert out["attempted"] >= 1 and set(line["metrics"]) == {"job_MBps", "setup_s"}


def plant_bfloat16(mp):
    app = importlib.import_module("locust_tpu_torch.apps.pagerank")

    orig = app.pagerank_step
    mp.setattr(app, "pagerank_step", lambda *a, **k: orig(*a, **k).bfloat16().float())


def plant_19_iterations(mp):
    app = importlib.import_module("locust_tpu_torch.apps.pagerank")

    orig = app.pagerank
    mp.setattr(app, "pagerank", lambda src, dst, num_nodes, num_iters=20, *a, **k:
               orig(src, dst, num_nodes, num_iters - 1, *a, **k))


def plant_heaviest_row_dropped(mp):
    app = importlib.import_module("locust_tpu_torch.apps.pagerank")

    orig = app.gather_add

    def gather_add(init, offsets, src_by_dst, schedule, warp_rows, ranks, inv_deg=None):
        total = orig(init, offsets, src_by_dst, schedule, warp_rows, ranks, inv_deg)
        total[schedule[0].long()] = init  # the row of the largest in-degree adds nothing
        return total

    mp.setattr(app, "gather_add", gather_add)


# fault -> (plant, scale, seed).  Twenty steps and nineteen part most at
# the ends of the graph's longest whiskers (nodes of in-degree 2), which
# converge slowest: by 1.09e-2 of a rank on the SCALE-24 graphs (an H100,
# two seeds), past the cell's 5e-3; by at most ~2e-3 on most small graphs,
# whose whiskers are short.  So that fault runs on a SCALE-16 graph with a
# whisker as deep as the large graphs' (1.58e-2 there).
FAULTS = {"bfloat16_ranks": (plant_bfloat16, 10, 2**33 + 5),
          "19_iterations": (plant_19_iterations, 16, 22),
          "heaviest_row_dropped": (plant_heaviest_row_dropped, 10, 2**33 + 5)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_incorrect(fault, monkeypatch):
    plant, scale, seed = FAULTS[fault]
    plant(monkeypatch)
    line, _ = run_tiny(scale=scale, seed=seed)
    assert not line["correct"], line["checks"]
    assert line["checks"]["nonfinite_ranks"]["value"] == 0


def test_the_deep_graph_reads_correct_without_the_fault():
    """Without the fault the same SCALE-16 graph reads correct: the check
    sees the iteration count, not the graph."""
    _, scale, seed = FAULTS["19_iterations"]
    line, _ = run_tiny(scale=scale, seed=seed)
    assert line["correct"], line["checks"]


def test_readers_on_a_traced_tiny_record():
    line, out = run_tiny(trace=True)
    assert line["correct"], line["checks"]
    record = out["record"]
    for name in METRICS:
        value = harness.reader(name)(record)
        assert value is None or math.isfinite(value), (name, value)
    # The port's spans are on: the host numbers are read on any device.
    assert harness.reader("pr_grouping_ms")(record) > 0
    assert harness.reader("pr_iter_host_us")(record) > 0
    assert all(j["iterations"] == 20 and len(j["iteration_us"]) == 20 for j in record["jobs"])


def test_readers_read_nothing_without_the_programs_numbers():
    """A record from a program without the spans, the counter or a trace:
    every reader returns None."""
    rec = {"jobs": [{"bytes": 1, "job_ms": 3.0}], "trace": None, "config": {},
           "graph": {"nodes": 8, "arcs": 64}, "device_name": "cpu"}
    assert [harness.reader(name)(rec) for name in METRICS] == [None] * len(METRICS)


@pytest.mark.parametrize("slower", [1.0, 1.7, 40.0])
def test_gather_add_roofline_is_at_most_100(slower):
    """At the bytes bound's own time a launch reads 100%; slower, less."""
    nodes, arcs, launches = 1 << 24, 1 << 29, 20
    least = roofline.pagerank_gather_min_bytes(nodes, arcs, index_bytes=4)
    per_launch = least / roofline.peak_bytes_s("NVIDIA H100 80GB HBM3") * slower
    record = {"graph": {"nodes": nodes, "arcs": arcs}, "device_name": "NVIDIA H100 80GB HBM3",
              "trace": {"launches": {"gather_add": launches},
                        "op_seconds": {"void (anonymous namespace)::gather_add_kernel<int, true>"
                                       "(float const*, int const*)": per_launch * launches,
                                       "Memcpy DtoH": 1.0}}}
    value = harness.reader("gather_add_roofline")(record)
    assert value <= 100.0 + 1e-9 and value == pytest.approx(100.0 / slower)


def test_reference_and_generator_import_nothing_of_the_port():
    import ast
    import os

    for rel in ("reference/pagerank.py", "graph.py"):
        with open(os.path.join(harness.BENCH, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("locust_tpu", "locust_tpu_torch", "jax")
                           for n in names), (rel, names)


def test_compare_counts_missing_and_nonfinite_ranks():
    from benchmark.reference import pagerank as reference

    want = np.full(4, 0.25)
    assert reference.compare(np.full(4, 0.25, np.float32), want) == {
        "rank_rel_err_max": 0.0, "rank_l1_err": 0.0, "nonfinite_ranks": 0}
    got = reference.compare(np.array([0.25, np.nan, 0.5], np.float32), want)
    assert got["nonfinite_ranks"] == 2 and got["rank_rel_err_max"] == pytest.approx(1.0)
    assert got["rank_l1_err"] == pytest.approx(0.25)
