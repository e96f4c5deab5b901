"""The benchmark's arithmetic on synthetic records: rate, median,
spread, idle share, the trace reduction and the roofline shares."""

import json

import pytest

from benchmark import harness, stats
from benchmark.frozen import profile, roofline


def test_rate_median_spread():
    assert stats.rate(300e6, 3.0) == 100e6
    with pytest.raises(ValueError):
        stats.rate(1, 0)
    assert stats.median([3, 1, 2]) == 2
    # statistics.quantiles (exclusive) of 1..9: 2.5, 5, 7.5
    assert stats.spread(range(1, 10)) == pytest.approx(5 / 5)


def test_idle_share_and_intervals():
    assert stats.merge_intervals([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert stats.idle_pct(0.25, 1.0) == 75.0
    with pytest.raises(ValueError):
        stats.idle_pct(1, 0)


def trace_file(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 1000.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "tokenize_kernel", "ts": 1100.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "tokenize_kernel", "ts": 1150.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1500.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 1950.0, "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "before", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1100.0, "dur": 5.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_trace_summary(tmp_path):
    # Host spans on perf_counter: the window opened at host time 10.0 s,
    # which is trace time 1000 us.
    spans = [("bench.load", 10.0, 10.0004), ("bench.fold", 10.0004, 10.001)]
    s = profile.summarize(trace_file(tmp_path), 10.0, spans)
    assert s["window_s"] == pytest.approx(1e-3)
    # busy: [1100,1250] + [1500,1700] + [1950,2000] clipped = 150 + 200 + 50 us
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["device_ops"] == 4 and s["op_counts"]["tokenize_kernel"] == 2
    assert profile.kernel_seconds(s, "tokenize") == pytest.approx(200e-6)
    gaps = dict(s["idle_gaps"])
    # gaps: [1000,1100] load, [1250,1500] fold (mid 1375 > 1400? no: 1375 < 1400 load)
    assert gaps["bench.load"] == pytest.approx((100 + 250) * 1e-6)
    assert gaps["bench.fold"] == pytest.approx(250e-6)
    assert stats.idle_pct(s["busy_s"], s["window_s"]) == pytest.approx(60.0)


def test_trace_without_window_or_ops(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 10}]}))
    assert profile.summarize(str(path), 0.0) is None
    path.write_text(json.dumps({"traceEvents": []}))
    assert profile.summarize(str(path), 0.0) is None


def test_roofline_shares():
    # PERF.md's table: 3,227,652 bytes at [4096,128], E=20, K=32; 11,796,480 at n=147,456 x 9.
    assert roofline.tokenize_min_bytes(4096, 128, 20, 32) == 3227652
    assert roofline.bitonic_min_bytes(147456, 9) == 11796480
    assert roofline.fused_min_bytes(4096, 128, 32) == 978949
    assert roofline.pagerank_gather_min_bytes(875713, 5105039, 4) == 34431572
    name = "NVIDIA H100 80GB HBM3"
    t = 3227652 / 3350e9
    assert roofline.roofline_pct(3227652, t, name) == pytest.approx(100.0)
    assert roofline.roofline_pct(3227652, 4 * t, name) == pytest.approx(25.0)
    assert roofline.roofline_pct(3227652, t, "cpu") is None


def test_readers_on_a_synthetic_record():
    e = {"block_lines": 4096, "line_width": 128, "emits_per_line": 20, "key_width": 32,
         "table_size": 65536}
    t_tok = 3227652 / 3350e9 * 5  # 20% of the bound
    record = {
        "config": {"engine": e}, "device_name": "NVIDIA H100 80GB HBM3",
        "jobs": [{"load_ms": 1.0, "fold_ms": 5.0, "stall_ms": 2.0},
                 {"load_ms": 3.0, "fold_ms": 7.0, "stall_ms": 4.0}],
        "trace": {"busy_s": 0.2, "window_s": 1.0, "device_ops": 234, "blocks": 2,
                  "op_seconds": {"tokenize_kernel": 2 * t_tok, "bitonic_coop_kernel<11>": 0.001},
                  "launches": {"tokenize": 2, "bitonic": 2}},
    }
    read = {m: harness.reader(m)(record) for m in (
        "ingest_ms", "fold_ms", "stream_stall_ms", "device_ops_per_block", "tokenize_roofline",
        "bitonic_roofline", "device_idle_pct", "device_idle_pct.stream",
        "device_ops_per_block.stream", "finalize_ms", "finalize_ms.stream")}
    assert read["ingest_ms"] == 2.0 and read["fold_ms"] == 6.0 and read["stream_stall_ms"] == 3.0
    assert read["device_ops_per_block"] == 117
    assert read["tokenize_roofline"] == pytest.approx(20.0)
    assert read["bitonic_roofline"] == pytest.approx(100 * 11796480 / 3350e9 / 0.0005)
    assert read["device_idle_pct"] == pytest.approx(80.0)
    assert read["device_idle_pct.stream"] == pytest.approx(80.0)
    assert read["device_ops_per_block.stream"] == 117
    assert read["finalize_ms"] is None and read["finalize_ms.stream"] is None
    empty = {"config": {"engine": e}, "jobs": [], "trace": None}
    for m in read:
        assert harness.reader(m)(empty) is None
