"""The TeraSort cell on the CPU at a tiny size: the ``gensort -a``
generator, a clean run read ``correct: true``, planted faults read
``correct: false``, the span attribution of device ops, and the cell's
seven per-layer readers.

Each run goes through the harness's driver as a run on the card would,
without the harness's look for a card, with the configuration's records
cut to a few thousand and the configuration's own limits.  Faults on
planted data run on records whose keys share 8-byte prefixes or repeat
exactly; the same records without the fault read correct."""

import copy
import json
import math
import os
import tempfile

import pytest
import torch

from benchmark import harness, records, span_device
from benchmark.frozen import roofline, sort_bytes
from benchmark.reference import terasort as reference

torch.set_num_threads(1)

CELL = "ts-huge-resident"
METRICS = ["ts_partition_dev_ms", "ts_local_sort_dev_ms", "ts_records_dev_ms",
           "ts_host_syncs_per_job", "ts_device_ops_per_job", "ts_sort_roofline",
           "device_idle_pct.terasort"]
H100 = "NVIDIA H100 80GB HBM3"


def run_tiny(n: int = 3000, seed: int = 2**33 + 5, trace: bool = False):
    """``(result line, driver output)`` of one run of ``n`` records on the CPU."""
    man = harness.manifest()
    cell, config, traffic = harness.resolve(man, CELL)
    config = copy.deepcopy(config)
    config["records"] = n
    with tempfile.TemporaryDirectory() as wd:
        ctx = harness.Context(workload=CELL, cell=cell, config=config, traffic=traffic,
                              seed=seed, seconds=0.3, trace=trace, device="cpu", workdir=wd)
        out = harness.run_cell(ctx)
    return harness.result_line(man, ctx, out), out


@pytest.mark.parametrize("seed", [0, 2**31 + 3, -(2**40) - 1])
def test_generator_is_seeded_and_lays_out_gensort_records(seed):
    got = records.gensort_records(1000, seed, "cpu")
    assert got.dtype == torch.uint8 and got.shape == (1000, 100)
    assert torch.equal(got, records.gensort_records(1000, seed, "cpu"))
    assert not torch.equal(got[:, :10], records.gensort_records(1000, seed + 1, "cpu")[:, :10])
    key = got[:, :10]
    assert int(key.min()) == 0x20 and int(key.max()) == 0x7E  # 95 characters, both ends drawn
    rows = [bytes(r.tolist()) for r in got[[0, 1, 999]]]
    for i, r in zip((0, 1, 999), rows):
        assert r[10:12] == b"  " and r[44:46] == b"  " and r[98:] == b"\r\n"
        assert r[12:44] == b"%032X" % i
        filler = r[46:98]
        assert all(filler[j:j + 4] == filler[j:j + 1] * 4 for j in range(0, 52, 4))
        assert set(filler) <= set(b"0123456789ABCDEF")
    # A later node's share numbers its records on.
    assert bytes(records.gensort_records(2, seed, "cpu", first=80_000_000)[1, 12:44].tolist()
                 ) == b"%032X" % 80_000_001


def test_clean_tiny_cell_is_correct():
    line, out = run_tiny()
    assert line["correct"], line["checks"]
    assert {k: v["value"] for k, v in line["checks"].items()} == {
        "wrong_records": 0, "unordered_pairs": 0, "dropped_records": 0}
    assert out["attempted"] >= 1 and set(line["metrics"]) == {"job_MBps", "setup_s"}
    assert all(j["out_records"] == 3000 and j["bytes"] == 300_000 for j in out["record"]["jobs"])


def _plant_prefixes(mp):
    """Every third record's key shares its first 8 bytes; the last two
    differ."""
    real = records.gensort_records

    def planted(n, seed, device="cuda", first=0):
        got = real(n, seed, device, first)
        got[::3, :8] = torch.tensor(list(b"TeraSort"), dtype=torch.uint8)
        return got

    mp.setattr(records, "gensort_records", planted)


def _plant_duplicates(mp):
    """Every third record's key is one of two keys, exactly."""
    real = records.gensort_records

    def planted(n, seed, device="cuda", first=0):
        got = real(n, seed, device, first)
        got[::3, :10] = torch.tensor(list(b"duplicate0"), dtype=torch.uint8)
        got[1::6, :10] = torch.tensor(list(b"duplicate1"), dtype=torch.uint8)
        return got

    mp.setattr(records, "gensort_records", planted)


def _sample_sort():
    import locust_tpu_torch.apps.sample_sort as app

    return app


def plant_key_cut_to_8_bytes(mp):
    app = _sample_sort()
    real = app.DistributedSort.sort_records
    mp.setattr(app.DistributedSort, "sort_records",
               lambda self, recs, key_bytes: real(self, recs, min(key_bytes, 8)))


def plant_unstable_sort(mp):
    """The local sort sees its rows reversed: equal keys come out in the
    reverse of their input order."""
    app = _sample_sort()
    real = app.sort_and_compact
    mp.setattr(app, "sort_and_compact", lambda b, mode="bitonic": real(
        app.KVBatch(b.key_lanes.flip(0), b.values.flip(0), b.valid.flip(0)), mode))


def _on_output(mp, change):
    app = _sample_sort()
    real = app.DistributedSort.sort_records

    def sort_records(self, recs, key_bytes):
        out, overflow = real(self, recs, key_bytes)
        return change(out), overflow

    mp.setattr(app.DistributedSort, "sort_records", sort_records)


def plant_dropped_record(mp):
    _on_output(mp, lambda out: out[1:])


def plant_swapped_pair(mp):
    _on_output(mp, lambda out: out[[1, 0, *range(2, out.shape[0])]])


# fault -> (plant in the port, plant in the data or None, the check it trips)
FAULTS = {"key_cut_to_8_bytes": (plant_key_cut_to_8_bytes, _plant_prefixes, "wrong_records"),
          "unstable_sort": (plant_unstable_sort, _plant_duplicates, "wrong_records"),
          "dropped_record": (plant_dropped_record, None, "dropped_records"),
          "swapped_pair": (plant_swapped_pair, None, "unordered_pairs")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_incorrect(fault, monkeypatch):
    plant, data, check = FAULTS[fault]
    if data is not None:
        data(monkeypatch)
    plant(monkeypatch)
    line, _ = run_tiny()
    assert not line["correct"], line["checks"]
    assert line["checks"][check]["value"] > 0 and line["checks"]["wrong_records"]["value"] > 0


@pytest.mark.parametrize("data", [_plant_prefixes, _plant_duplicates])
def test_planted_data_reads_correct_without_the_fault(data, monkeypatch):
    data(monkeypatch)
    line, _ = run_tiny()
    assert line["correct"], line["checks"]


def test_readers_on_a_traced_tiny_record():
    line, out = run_tiny(trace=True)
    assert line["correct"], line["checks"]
    record = out["record"]
    for name in METRICS:
        value = harness.reader(name)(record)
        assert value is None or math.isfinite(value), (name, value)
    # The port's counter is on: read on any device; the CPU has no trace.
    assert harness.reader("ts_host_syncs_per_job")(record) == 3
    assert all(j["rows"] == 3000 and j["local_ms"] > 0 for j in record["jobs"])
    assert harness.reader("ts_sort_roofline")(record) is None  # no peak for the CPU


def test_readers_read_nothing_without_the_programs_numbers():
    rec = {"jobs": [{"bytes": 1, "job_ms": 3.0}], "trace": None, "config": {},
           "device_name": "cpu", "records": {"n": 8, "record_bytes": 100, "key_bytes": 10}}
    assert [harness.reader(name)(rec) for name in METRICS] == [None] * len(METRICS)
    rec["trace"] = {"jobs": 1, "device_ops": 40, "busy_s": 0.5, "window_s": 1.0,
                    "span_seconds": {}}
    assert harness.reader("ts_partition_dev_ms")(rec) is None
    assert harness.reader("ts_device_ops_per_job")(rec) == 40


@pytest.mark.parametrize("slower", [1.0, 1.7, 40.0])
def test_sort_roofline_is_at_most_100(slower):
    """At the bytes bound's own time a job reads 100%; slower, less."""
    n = 80_000_000
    least = sort_bytes.terasort_min_bytes(n, 100)
    assert least == 16_000_000_000
    job_ms = least / roofline.peak_bytes_s(H100) * 1e3 * slower
    rec = {"jobs": [{"job_ms": job_ms}], "device_name": H100,
           "records": {"n": n, "record_bytes": 100, "key_bytes": 10}}
    value = harness.reader("ts_sort_roofline")(rec)
    assert value <= 100.0 + 1e-9 and value == pytest.approx(100.0 / slower)


def _event(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_device_ops_go_to_the_innermost_span_open_at_their_launch(tmp_path):
    """Window [1000, 2000) us on the trace's clock opens at host time 5.0 s;
    spans on the host clock; each kernel attributed by its launch."""
    events = [
        _event("bench.window", "user_annotation", 1000, 1000),
        _event("cudaLaunchKernel", "cuda_runtime", 1100, 5, 1),   # under outer only
        _event("cudaLaunchKernel", "cuda_runtime", 1300, 5, 2),   # under inner
        _event("cudaMemcpyAsync", "cuda_runtime", 1600, 5, 3),    # under no span
        _event("cuLaunchKernel", "cuda_driver", 1410, 5, 4),      # inner, a driver launch
        _event("k1", "kernel", 1200, 100, 1),
        _event("k2", "kernel", 1350, 50, 2),
        _event("copy", "gpu_memcpy", 1650, 20, 3),
        _event("k4", "kernel", 1990, 30, 4),                      # clipped at the window's end
        _event("k5", "kernel", 1500, 40, 99),                     # its launch not traced
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    spans = [("outer", 5.0, 5.0005), ("inner", 5.0002, 5.0005)]  # 1000-1500, 1200-1500 us
    got = span_device.device_seconds_by_span(str(path), 5.0, spans)
    assert got == {"outer": pytest.approx(100e-6), "inner": pytest.approx(60e-6)}
    assert span_device.device_seconds_by_span(str(path), 5.0, []) == {}
    path.write_text(json.dumps({"traceEvents": events[1:]}))
    assert span_device.device_seconds_by_span(str(path), 5.0, spans) == {}


def test_compare_counts_wrong_unordered_and_missing():
    want = records.gensort_records(50, 3, "cpu")
    want = reference.terasort(want, 10)
    assert reference.compare(want, want, 10) == {
        "wrong_records": 0, "unordered_pairs": 0, "missing_records": 0}
    swapped = want[[1, 0, *range(2, 50)]]
    assert reference.compare(swapped, want, 10) == {
        "wrong_records": 2, "unordered_pairs": 1, "missing_records": 0}
    assert reference.compare(want[1:], want, 10) == {
        "wrong_records": 50, "unordered_pairs": 0, "missing_records": 1}
    # An unsigned key: 0x80 sorts after 0x7F.
    hi = want[:2].clone()
    hi[0, 0], hi[1, 0] = 0x80, 0x7F
    assert reference.unordered_pairs(hi, 10) == 1
    assert torch.equal(reference.terasort(hi, 10), hi[[1, 0]])


def test_reference_and_generator_import_nothing_of_the_port():
    import ast

    for rel in ("reference/terasort.py", "records.py", "span_device.py",
                "frozen/sort_bytes.py"):
        with open(os.path.join(harness.BENCH, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("locust_tpu", "locust_tpu_torch", "jax")
                           for n in names), (rel, names)
