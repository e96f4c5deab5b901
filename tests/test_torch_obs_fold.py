"""PyTorch port, telemetry inside the fold: the ``engine.*`` spans and
the ``engine.host_syncs`` counter of ``run_fused``, ``run``,
``run_batch`` and ``run_stream``, the reader thread's ``stream.read`` and
``stream.wait``, and the CLI's spans in its ``--profile-dir`` trace.
All on the CPU, where the counter counts what the card would wait on."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import collections
import json
import threading

import numpy as np
import pytest

from locust_tpu_torch import obs
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.engine import MapReduceEngine
from locust_tpu_torch.io import loader

KW = dict(block_lines=64, line_width=128, key_width=16, emits_per_line=8)
LINES = [b"alpha beta gamma delta", b"beta gamma", b"epsilon alpha alpha zeta"] * 70
FOLD = ("engine.fold.block", "engine.fold.map", "engine.fold.sort", "engine.fold.reduce")


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.disable()
    yield
    obs.disable()


def _traced(run):
    """``(result, spans, counters)`` of ``run()`` under a fresh tracer."""
    t = obs.enable()
    res = run()
    spans, counters = t.spans(), obs.metrics_snapshot()["counters"]
    obs.disable()
    return res, spans, counters


def _counts(spans) -> dict:
    return dict(collections.Counter(name for name, *_ in spans))


def _engine(mode: str, **kw) -> MapReduceEngine:
    return MapReduceEngine(EngineConfig(**KW, sort_mode=mode, **kw), device="cpu")


@pytest.mark.parametrize("mode", ["hash", "bitonic"])
def test_run_fused_records_each_block_and_two_host_syncs(mode):
    """N blocks: N block spans with a map, a sort and a reduce inside
    each, one staging span and one drain; the only host syncs are the
    two counters' reads at the drain."""
    eng = _engine(mode)
    rows = eng.rows_from_lines(LINES)  # 210 lines: 4 blocks
    res, spans, counters = _traced(lambda: eng.run_fused(rows))
    assert _counts(spans) == {**dict.fromkeys(FOLD, 4), "engine.stage_blocks": 1,
                              "engine.fold.drain": 1}
    assert counters == {"engine.host_syncs": 2}
    parent = {(name, args.get("i")): args.get("parent") for name, _, _, _, args in spans}
    assert {p for (n, _), p in parent.items() if n in FOLD[1:]} == {"engine.fold.block"}
    assert [i for name, _, _, _, a in spans if name == "engine.fold.block"
            for i in [a["i"]]] == [0, 1, 2, 3]
    assert parent[("engine.fold.block", 0)] is None
    assert parent[("engine.stage_blocks", None)] is None
    assert parent[("engine.fold.drain", None)] is None
    # Every map, sort and reduce lies inside its block's span.
    blocks = [(s0, s1) for name, s0, s1, _, _ in spans if name == "engine.fold.block"]
    for name, s0, s1, _, _ in spans:
        if name in FOLD[1:]:
            assert any(b0 <= s0 <= s1 <= b1 for b0, b1 in blocks)
    assert res.to_host_pairs() == _engine(mode).run_fused(rows).to_host_pairs()


@pytest.mark.parametrize("mode", ["hasht", "hasht-mxu", "fused"])
def test_hasht_family_records_no_sort(mode):
    """The hash-table fold has no sort: a map and a reduce a block, and
    one read of the unresolved count a fold (under ``fused`` the
    kernel's flag read as well)."""
    eng = _engine(mode)
    rows = eng.rows_from_lines(LINES)
    _, spans, counters = _traced(lambda: eng.run_fused(rows))
    got = _counts(spans)
    assert "engine.fold.sort" not in got
    assert got == {"engine.fold.block": 4, "engine.fold.map": 4, "engine.fold.reduce": 4,
                   "engine.stage_blocks": 1, "engine.fold.drain": 1}
    flags = 4 if mode == "fused" else 0
    assert counters == {"engine.host_syncs": 2 + 4 + flags}


def test_run_and_run_batch_drain_once():
    eng = _engine("hash")
    rows = eng.rows_from_lines(LINES)
    _, spans, counters = _traced(lambda: eng.run(rows))
    # run copies each block as it folds it: no staging span; the drain
    # holds its closing sync, then the two counters are read.
    assert _counts(spans) == {**dict.fromkeys(FOLD, 4), "engine.fold.drain": 1}
    assert counters == {"engine.host_syncs": 3}
    stack = np.stack([eng.prepare_blocks(rows).numpy()] * 2)
    _, spans, counters = _traced(lambda: eng.run_batch(stack))
    assert _counts(spans) == {**dict.fromkeys(FOLD, 8), "engine.fold.drain": 1}
    assert counters == {"engine.host_syncs": 1}


def test_run_stream_records_reads_waits_and_counts_the_backpressure_waits():
    """N blocks through the reader thread: N pulls plus the one that
    finds the end, on the reader's own thread with no parent; at most as
    many waits on the fold's thread; the counter holds the N - DEPTH
    backpressure waits, the closing sync and the two counters' reads."""
    eng = _engine("hash")
    rows = eng.rows_from_lines(LINES * 4)  # 840 lines
    blocks = [rows[i:i + 64] for i in range(0, len(rows), 64)]
    n = len(blocks)
    assert n > eng.STREAM_DISPATCH_DEPTH
    t = obs.enable()
    res = eng.run_stream(iter(blocks))
    spans, counters = t.spans(), obs.metrics_snapshot()["counters"]
    mine = t.spans(thread=threading.get_ident())
    got = _counts(spans)
    assert res.stream["blocks"] == n
    assert got["stream.read"] == n + 1 and got.get("stream.wait", 0) <= n + 1
    assert got["stream.block"] == got["engine.fold.map"] == got["engine.fold.sort"] == n
    assert got["engine.stage_blocks"] == n  # each block's pad into the staging ring
    assert got["engine.fold.drain"] == 1 and "engine.fold.block" not in got
    assert counters["engine.host_syncs"] == (n - eng.STREAM_DISPATCH_DEPTH) + 1 + 2
    reads = [s for s in spans if s[0] == "stream.read"]
    assert not any(s[0] == "stream.read" for s in mine)
    assert {s[4].get("parent") for s in reads} == {None}
    assert {s[0] for s in mine} >= {"stream.block", "engine.stage_blocks", "engine.fold.map",
                                    "engine.fold.drain"}
    assert {s[4]["parent"] for s in mine if s[0] == "engine.fold.map"} == {"stream.block"}


def test_prefetch_waits_only_on_an_empty_queue():
    """A source slower than the consumer makes the consumer wait; a
    ready queue costs no wait span."""
    import time

    def slow():
        for i in range(3):
            time.sleep(0.02)
            yield i

    t = obs.enable()
    assert list(loader.prefetch_blocks(slow())) == [0, 1, 2]
    got = _counts(t.spans())
    assert got["stream.read"] == 4 and 3 <= got["stream.wait"] <= 4
    obs.disable()
    t = obs.enable()
    ready = loader.prefetch_blocks(iter(range(5)), depth=8)
    assert next(ready) == 0  # starts the reader: this get may wait
    time.sleep(0.2)  # the reader fills the queue
    assert list(ready) == [1, 2, 3, 4]
    got = _counts(t.spans())
    assert got["stream.read"] == 6 and got.get("stream.wait", 0) <= 1


def test_reader_records_into_the_consumers_scope():
    """A consumer whose telemetry is masked gets no reader spans in the
    process tracer; a consumer under a request tracer gets them there."""
    t = obs.enable()
    with obs.scoped(None):
        assert list(loader.prefetch_blocks(iter(range(3)))) == [0, 1, 2]
    assert t.spans() == []
    req = obs.Tracer(process="request")
    with obs.scoped(req):
        assert list(loader.prefetch_blocks(iter(range(3)))) == [0, 1, 2]
    assert t.spans() == [] and _counts(req.spans())["stream.read"] == 4


@pytest.mark.parametrize("trace_out", [False, True])
def test_cli_puts_its_spans_in_the_profile_only_with_trace_out(trace_out, tmp_path, capfdbinary):
    """``--trace-out`` with ``--profile-dir``: the profiler's export holds
    each span as a range of its name; ``--profile-dir`` alone holds none."""
    from locust_tpu_torch import cli
    from locust_tpu_torch.utils import profiling

    path = tmp_path / "c.txt"
    path.write_bytes(b"b a\nc a b\n" * 50)
    prof = tmp_path / "prof"
    extra = ["--trace-out", str(tmp_path / "t.trace.json")] if trace_out else []
    assert cli.main([str(path), "--profile-dir", str(prof), "--backend", "cpu",
                     "--block-lines", "64", "--no-timing", *extra]) == 0
    assert capfdbinary.readouterr().out == b"a\t100\nb\t100\nc\t50\n"
    (trace,) = prof.glob(f"*{profiling.TRACE_SUFFIX}")
    events = json.load(open(trace))["traceEvents"]
    ranges = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    ours = {k: v for k, v in ranges.items() if k in obs.NAMES}
    if trace_out:
        assert ours["engine.fold.block"] == 2 and ours["engine.fold.sort"] == 2
        assert ours["cli.run"] == ours["engine.fold.drain"] == ours["engine.stage_blocks"] == 1
    else:
        assert ours == {}
    assert obs.current() is None  # the CLI turned telemetry off at exit
