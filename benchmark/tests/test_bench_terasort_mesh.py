"""The four-card TeraSort cell on the CPU at a tiny size: the cross-rank
reference against the one-card reference, a clean run of the driver on a
gloo world of 4 CPU ranks (750 records a rank) read ``correct: true``,
faults planted in the ranks read ``correct: false``, the cell's nine
per-layer readers, and the watchdog that ends a world whose rank exits or
stalls.  Ranks 1-3 run as processes of ``benchmark/tests/mesh_plant.py``,
which plants the same fault in each of them as the test plants in rank 0
(the test's process)."""

import os
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from benchmark import harness, records
from benchmark.drivers import terasort_mesh
from benchmark.reference import terasort as one, terasort_mesh as reference
from benchmark.tests import mesh_plant

torch.set_num_threads(1)

METRICS = ["ts_exchange_dev_ms.mesh4", "ts_a2a_GB_per_job.mesh4", "ts_partition_dev_ms.mesh4",
           "ts_local_sort_dev_ms.mesh4", "device_idle_pct.terasort_mesh4",
           "ts_records_dev_ms.mesh4", "ts_host_syncs_per_job.mesh4",
           "ts_device_ops_per_job.mesh4", "ts_sort_mesh4_roofline"]
KEY = 10


def _planted_ranks(sizes):
    """Each rank's gensort records, keys sharing 8-byte prefixes and exact
    duplicates that fall on every rank."""
    out = []
    for r, n in enumerate(sizes):
        recs = records.gensort_records(n, 40 + r, "cpu", first=sum(sizes[:r]))
        recs[::4, :8] = torch.tensor(list(b"TeraSort"), dtype=torch.uint8)
        recs[1::4, :KEY] = torch.tensor(list(b"duplicate0"), dtype=torch.uint8)
        out.append(recs)
    return out


def test_global_order_is_the_one_card_order_of_the_ranks_in_rank_order():
    ranks = _planted_ranks([300, 0, 517, 211])
    order, sizes = reference.global_order(lambda r: ranks[r], 4, KEY)
    whole = torch.cat(ranks)
    assert sizes == [300, 0, 517, 211]
    assert torch.equal(order, one.order(whole, KEY))
    # Every share, gathered rank by rank, is the sorted whole's slice.
    want = one.terasort(whole, KEY)
    for lo, count in ((0, 300), (300, 400), (700, 328), (1000, 0)):
        got = reference.share(order, lo, count, sizes, lambda r: ranks[r])
        assert torch.equal(got.reshape(-1, 100), want[lo:lo + count])


def test_boundary_pairs_skip_empty_ranks():
    a, b = (torch.tensor(list(k + bytes(90)), dtype=torch.uint8) for k in (b"aaaaaaaaaa",
                                                                            b"bbbbbbbbbb"))
    assert reference.boundary_pairs([[a, a], None, [b, b]], KEY) == 0
    assert reference.boundary_pairs([[b, b], None, [a, a], [a, b]], KEY) == 1
    assert reference.boundary_pairs([None, None], KEY) == 0


def test_rank_seeds_differ_and_repeat():
    seeds = [terasort_mesh.rank_seed(2**40 + 3, r) for r in range(4)]
    assert len(set(seeds)) == 4 and seeds == [terasort_mesh.rank_seed(2**40 + 3, r)
                                              for r in range(4)]
    assert seeds[0] != terasort_mesh.rank_seed(2**40 + 4, 0)


def _run(monkeypatch, fault: str = "none", trace: bool = False):
    mesh_plant.plant(fault, 0, monkeypatch.setattr)
    monkeypatch.setattr(terasort_mesh, "rank_command", mesh_plant.command_through_this_file(fault))
    with tempfile.TemporaryDirectory() as wd:
        ctx = mesh_plant.tiny_context(wd, trace=trace)
        out = harness.run_cell(ctx)
    return harness.result_line(harness.manifest(), ctx, out), out


def test_clean_tiny_world_is_correct_and_its_readers_read(monkeypatch):
    line, out = _run(monkeypatch, trace=True)
    assert line["correct"], line["checks"]
    assert {k: v["value"] for k, v in line["checks"].items()} == {
        "wrong_records": 0, "unordered_pairs": 0, "dropped_records": 0}
    assert line["device"]["count"] == 4 and out["attempted"] >= 1
    jobs = out["record"]["jobs"]
    assert all(j["bytes"] == 4 * 750 * 100 for j in jobs)
    # Rank 0 sends 4 bins of 376 slots: 3 lanes, a value and a valid word,
    # and 100 record bytes a slot.
    sent = 4 * 376 * (5 * 4 + 100)
    assert all(j["a2a_calls"] == 2 and j["a2a_bytes"] == sent and j["exchange_ms"] > 0
               for j in jobs)
    # The splitters' two count reads, then the overflow and the output's rows in one.
    assert all(j["host_syncs"] == 3 for j in jobs)
    assert line["metrics"] == {"ts_a2a_GB_per_job.mesh4": {"value": sent / 1e9, "unit": "GB"},
                               "ts_host_syncs_per_job.mesh4": {"value": 3.0,
                                                               "unit": "syncs/job"}}
    # The CPU has no device trace and no peak: the device readers and the
    # roofline read nothing.
    assert [harness.reader(m)(out["record"]) for m in METRICS if m not in line["metrics"]] \
        == [None] * 7


def test_untraced_line_reports_the_end_to_end_metrics(monkeypatch):
    line, out = _run(monkeypatch)
    assert line["correct"] and set(line["metrics"]) == {"job_MBps", "setup_s"}
    assert "a2a_bytes" not in out["record"]["jobs"][0]  # the tracer is off


FAULTS = {"swapped_across_boundary": "unordered_pairs", "dropped_on_rank_2": "dropped_records",
          "key_cut_to_8_bytes": "wrong_records", "ties_in_wrong_rank_order": "wrong_records"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_reads_incorrect(fault, monkeypatch):
    line, _ = _run(monkeypatch, fault)
    assert not line["correct"], line["checks"]
    assert line["checks"][FAULTS[fault]]["value"] > 0
    assert line["checks"]["wrong_records"]["value"] > 0


def test_readers_read_nothing_without_the_programs_numbers():
    rec = {"jobs": [{"bytes": 1, "job_ms": 3.0}], "trace": None, "config": {},
           "device_name": "cpu", "records": {"n": 8, "record_bytes": 100, "key_bytes": 10}}
    assert [harness.reader(name)(rec) for name in METRICS] == [None] * len(METRICS)
    rec["trace"] = {"jobs": 1, "device_ops": 40, "busy_s": 0.5, "window_s": 1.0,
                    "span_seconds": {"sample_sort.partition": 0.002}}
    assert [harness.reader(name)(rec) for name in METRICS] == [None, None, 2.0, None, 50.0,
                                                               None, None, 40.0, None]
    rec["trace"]["span_seconds"]["sample_sort.exchange"] = 0.04
    assert harness.reader("ts_exchange_dev_ms.mesh4")(rec) == 40.0


def test_roofline_is_the_whole_sorts_bytes_over_all_four_cards():
    """320 M records at 2 x 100 bytes each over four cards' peak: a job of
    exactly that many seconds reads 100%, the same share each card's
    quarter reads against its own peak."""
    from benchmark.frozen import roofline

    name = "NVIDIA H100 80GB HBM3"
    least = 2 * 100 * 320_000_000
    rec = {"jobs": [{"job_ms": 1e3 * least / 4 / roofline.peak_bytes_s(name)}],
           "config": {"chips": 4}, "device_name": name,
           "records": {"n": 320_000_000, "record_bytes": 100, "key_bytes": 10}}
    assert harness.reader("ts_sort_mesh4_roofline")(rec) == pytest.approx(100.0)
    one_card = dict(rec, records={"n": 80_000_000, "record_bytes": 100, "key_bytes": 10})
    assert harness.reader("ts_sort_roofline")(one_card) == pytest.approx(100.0)


@pytest.mark.parametrize("fault", ["exit_rank_1", "stall_rank_1"])
def test_watchdog_ends_the_world_promptly(fault):
    t0 = time.monotonic()
    got = subprocess.run([sys.executable, mesh_plant.__file__, "world", fault],
                         capture_output=True, text=True, timeout=120, cwd=harness.ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert got.returncode == 1 and time.monotonic() - t0 < 60
    assert not [ln for ln in got.stdout.splitlines() if ln.startswith("{")]
    # A stalled rank stalls the ranks waiting for it in a collective too.
    why = "rank 1 exited 1" if fault == "exit_rank_1" else "made no progress for 10 s"
    assert why in got.stderr and "rank 1's log ends" in got.stderr, got.stderr[-3000:]


def test_new_reference_and_driver_import_nothing_of_jax():
    import ast

    for rel in ("reference/terasort_mesh.py", "drivers/terasort_mesh.py"):
        with open(os.path.join(harness.BENCH, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            banned = ("locust_tpu", "jax") + (("locust_tpu_torch",) if "reference" in rel
                                              else ())
            assert not any(n.split(".")[0] in banned for n in names), (rel, names)
