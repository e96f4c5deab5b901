"""PyTorch port, device-time capture and attribution
(``utils/profiling.py``, ``obs/attribution.py``): ``family_ms`` and
``family_join`` give the JAX package's output for the same summaries;
``profile_device`` never raises and never returns a stale capture;
``attributed_run`` annotates the Process-stage spans of its own run;
the CLI's ``--profile-dir`` leaves a trace."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from locust_tpu.obs import attribution as jattr
from locust_tpu.utils import profiling as jprof
from locust_tpu_torch import obs
from locust_tpu_torch.config import SORT_MODES, EngineConfig
from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.obs import attribution as tattr
from locust_tpu_torch.utils import profiling as tprof

TOTALS = {
    "sort.3": 1.5, "custom-call.2": 0.25, "fused_kernel_call": 2.0, "scatter-add": 0.75,
    "gather.1": 0.5, "dot.7": 0.125, "convert.4": 9.0, "Fused_Kernel.mosaic": 0.0625,
}


def test_family_ms_equals_jax():
    for frags in (jprof.SORT_OP_FRAGMENTS, jprof.SCATTER_OP_FRAGMENTS, jprof.DOT_OP_FRAGMENTS,
                  jprof.FUSED_KERNEL_OP_FRAGMENTS, ("convert",), ()):
        for excl in ((), jprof.FUSED_KERNEL_OP_FRAGMENTS):
            assert tprof.family_ms(TOTALS, frags, excl) == jprof.family_ms(TOTALS, frags, excl)


SUMMARIES = [
    {"sort_ms": 1.25, "scatter_ms": 0.5, "dot_ms": 0.25, "kernel_ms": 2.0,
     "device_total_ms": 9.0, "device_plane": "/device:TPU:0"},
    {"sort_ms": 0.0, "scatter_ms": 3.0, "dot_ms": 0.0, "kernel_ms": 0.0,
     "device_total_ms": 3.5, "device_plane": "cuda"},
    {"device_plane": None},
    {"error": "no trace produced"},
]


@pytest.mark.parametrize("mode", SORT_MODES)
@pytest.mark.parametrize("i", range(len(SUMMARIES)))
def test_family_join_equals_jax(mode, i):
    assert tattr.family_join(SUMMARIES[i], mode) == jattr.family_join(SUMMARIES[i], mode)


def test_cuda_kernel_names_fall_in_their_families():
    """Kernel B's and kernel C's entry symbols, cub's radix sort and the
    scatter kernels each count in exactly their family."""
    sort = ("bitonic_tile_kernel", "bitonic_cross_kernel", "bitonic_coop_kernel",
            "void cub::CUB_200700_900_NS::DeviceRadixSortOnesweepKernel<...>")
    scatter = ("void at::native::_scatter_gather_elementwise_kernel<128, 8>(int, ...)",
               "void at::native::indexFuncLargeIndex<int, long, 2, 2, -2, true>(...)",
               "void at::native::index_elementwise_kernel<128, 4>(...)")
    families = {"sort": (tprof.SORT_OP_FRAGMENTS, tprof.FUSED_KERNEL_OP_FRAGMENTS),
                "scatter": (tprof.SCATTER_OP_FRAGMENTS, ()),
                "dot": (tprof.DOT_OP_FRAGMENTS, ()),
                "kernel": (tprof.FUSED_KERNEL_OP_FRAGMENTS, ())}

    def member(name):
        return [f for f, (frags, excl) in families.items()
                if tprof.family_ms({name: 1.0}, frags, excl) == 1.0]

    for name in sort:
        assert member(name) == ["sort"], name
    for name in scatter:
        assert member(name) == ["scatter"], name
    assert member("fused_preagg_kernel") == ["kernel"]
    assert member("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32") == ["dot"]
    assert member("tokenize_kernel") == []


def test_profile_device_captures_sort_on_the_cpu(tmp_path):
    x = torch.arange(1 << 16, dtype=torch.int64) % 977
    result, summary, path = tprof.profile_device(lambda: torch.sort(x).values,
                                                 str(tmp_path / "trace"))
    assert result is not None and torch.equal(result, torch.sort(x).values)
    assert "error" not in summary, summary
    assert path is not None and path.endswith(tprof.TRACE_SUFFIX)
    assert summary["device_plane"] == "cpu"
    assert summary["device_total_ms"] > 0 and summary["sort_ms"] > 0
    assert any("sort" in name for name, _ in summary["top_ops"])
    assert summary["kernel_ms"] == 0.0


def test_parse_trace_counts_device_ops_and_top_level_cpu_ops(tmp_path):
    """Device kernels and copies when present; else the CPU's top-level
    ops, so a nested op is not counted twice."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 0, "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 10, "dur": 50, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::index_add_", "ts": 200, "dur": 30,
         "pid": 1, "tid": 1},
    ]
    p = tmp_path / f"a{tprof.TRACE_SUFFIX}"
    p.write_text(json.dumps({"traceEvents": ev}))
    s = tprof.parse_trace(str(p))
    assert s["device_plane"] == "cpu" and s["device_total_ms"] == 0.13
    assert s["sort_ms"] == 0.1 and s["scatter_ms"] == 0.03
    ev += [{"ph": "X", "cat": "kernel", "name": "bitonic_coop_kernel", "ts": 5, "dur": 40,
            "pid": 0, "tid": 7},
           {"ph": "X", "cat": "kernel", "name": "fused_preagg_kernel", "ts": 60, "dur": 20,
            "pid": 0, "tid": 7},
           {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90, "dur": 10,
            "pid": 0, "tid": 8}]
    p.write_text(json.dumps({"traceEvents": ev}))
    s = tprof.parse_trace(str(p))
    assert s["device_plane"] == "cuda" and s["device_total_ms"] == 0.07
    assert (s["sort_ms"], s["kernel_ms"], s["scatter_ms"]) == (0.04, 0.02, 0.0)


def test_parse_trace_missing_or_garbled_file_is_an_error_dict(tmp_path):
    assert "error" in tprof.parse_trace(str(tmp_path / "missing.pt.trace.json"))
    bad = tmp_path / "bad.pt.trace.json"
    bad.write_text("{not json")
    assert "error" in tprof.parse_trace(str(bad))


def test_profile_device_ignores_stale_capture_in_reused_dir(tmp_path):
    out_dir = tmp_path / "trace"
    stale_dir = out_dir / "old"
    stale_dir.mkdir(parents=True)
    stale = stale_dir / f"host{tprof.TRACE_SUFFIX}"
    stale.write_text("not a real capture")
    x = torch.arange(1 << 12) % 97
    result, summary, path = tprof.profile_device(lambda: torch.sort(x).values, str(out_dir))
    assert result is not None
    assert path is not None and path != str(stale)
    assert "error" not in summary, summary


def test_profile_device_reports_stale_only_dir_as_error(tmp_path, monkeypatch):
    out_dir = tmp_path / "trace"
    out_dir.mkdir()
    (out_dir / f"old{tprof.TRACE_SUFFIX}").write_text("stale")
    monkeypatch.setattr(tprof, "device_trace", lambda _d: contextlib.nullcontext())
    result, summary, path = tprof.profile_device(lambda: 1, str(out_dir))
    assert path is None and result == 1
    assert "error" in summary and "stale" in summary["error"]


def test_newest_trace_exclude_filter(tmp_path):
    a = tmp_path / f"a{tprof.TRACE_SUFFIX}"
    b = tmp_path / f"b{tprof.TRACE_SUFFIX}"
    a.write_text("a")
    b.write_text("b")
    os.utime(a, (1, 1))
    assert tprof.newest_trace(str(tmp_path)) == str(b)
    assert tprof.newest_trace(str(tmp_path), exclude={str(b)}) == str(a)
    assert tprof.newest_trace(str(tmp_path), exclude={str(a), str(b)}) is None


def test_profile_device_never_raises(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(tprof, "device_trace", boom)
    result, summary, path = tprof.profile_device(lambda: 1, str(tmp_path / "t"))
    assert result is None and path is None
    assert "error" in summary
    monkeypatch.undo()

    def failing():
        raise ValueError("the run failed")

    result, summary, path = tprof.profile_device(failing, str(tmp_path / "u"))
    assert result is None and path is None and "the run failed" in summary["error"]


def test_span_timer_report_equals_jax():
    t, j = tprof.SpanTimer(), jprof.SpanTimer()
    t.spans_ms = j.spans_ms = {"small": 10.0, "big": 70.0, "mid": 20.0, "tie": 20.0}
    assert t.report() == j.report()
    assert tprof.SpanTimer().report() == ""


def _rows(cfg):
    lines = [b"the quick brown fox", b"jumps over the lazy dog", b"the end"] * 40
    return bytes_ops.strings_to_rows(lines, cfg.line_width)


@pytest.fixture
def tracer():
    obs.disable()
    tr = obs.enable(process="test")
    yield tr
    obs.disable()


@pytest.mark.parametrize("mode", ["bitonic", "hasht", "fused"])
def test_attributed_run_annotates_this_runs_process_spans(tmp_path, tracer, mode):
    from locust_tpu_torch.engine import MapReduceEngine

    cfg = EngineConfig(block_lines=64, line_width=64, emits_per_line=8, sort_mode=mode,
                       use_pallas=True)
    eng = MapReduceEngine(cfg, device="cpu")
    rows = _rows(cfg)
    warm = eng.timed_run(rows)  # its spans must stay unannotated
    res, summary, path, join = tattr.attributed_run(lambda: eng.timed_run(rows),
                                                    str(tmp_path / "prof"), mode)
    assert res.to_host_pairs() == warm.to_host_pairs()
    assert "error" not in join, join
    assert path is not None and join["device_plane"] == "cpu"
    assert join["process_device_ms"] is not None
    assert join["process_family"] == {"bitonic": "sort", "hasht": "scatter+sort",
                                      "fused": "scatter+sort+kernel"}[mode]
    spans = [e for e in tracer._events if e.get("name") == tattr.PROCESS_STAGE_SPAN]
    n_blocks = -(-rows.shape[0] // cfg.block_lines)
    assert len(spans) == 2 * n_blocks
    assert [("process_family" in e["args"]) for e in spans] == [False] * n_blocks + [True] * n_blocks
    joins = [e for e in tracer._events if e.get("name") == "obs.device_join"]
    assert len(joins) == 1 and joins[0]["args"]["spans_annotated"] == n_blocks


def test_attributed_run_without_a_tracer_still_joins(tmp_path):
    obs.disable()
    x = torch.arange(5000) % 13
    res, summary, path, join = tattr.attributed_run(lambda: torch.sort(x), str(tmp_path), "lex")
    assert join["process_family"] == "sort" and join["process_device_ms"] > 0


def test_cli_profile_dir_leaves_a_trace(tmp_path, capfdbinary):
    from locust_tpu_torch import cli

    path = tmp_path / "c.txt"
    path.write_bytes(b"b a\nc a b\n" * 50)
    prof = tmp_path / "prof"
    assert cli.main([str(path), "--profile-dir", str(prof), "--backend", "cpu",
                     "--block-lines", "64"]) == 0
    out = capfdbinary.readouterr()
    assert out.out == b"a\t100\nb\t100\nc\t50\n"
    traces = list(prof.glob(f"*{tprof.TRACE_SUFFIX}"))
    assert len(traces) == 1
    summary = tprof.parse_trace(str(traces[0]))
    assert "error" not in summary and summary["device_total_ms"] > 0
    assert b"profiler trace written" in out.err


def test_device_trace_exports_on_exit(tmp_path):
    with tprof.device_trace(str(tmp_path)):
        np.testing.assert_array_equal(torch.arange(4).numpy(), np.arange(4))
        torch.ones(8).sum()
    (trace,) = tmp_path.glob(f"*{tprof.TRACE_SUFFIX}")
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
