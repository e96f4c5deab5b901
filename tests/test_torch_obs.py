"""PyTorch port, telemetry (``locust_tpu_torch.obs``): the tracer, the
metrics and the schema against the JAX package's, the tracer's clock and
parents, the zero-overhead disabled path, and the engine's spans, events
and metrics equal to the JAX engine's for one ``timed_run`` and one
checkpointed ``run_stream`` (the port's own names counted apart)."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import collections
import json
import time
import types

import pytest
import torch

from locust_tpu import obs as jobs
from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.engine import MapReduceEngine as JEngine
from locust_tpu.obs import names as jnames
from locust_tpu.obs.schema import validate_trace as jvalidate
from locust_tpu_torch import obs
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.engine import MapReduceEngine as TEngine
from locust_tpu_torch.obs import names as tnames
from locust_tpu_torch.obs.schema import validate_trace

# The port's own section of the registry (obs/names.py), which JAX lacks.
PORT_ONLY = {
    "engine.stage_blocks": "span", "engine.fold.block": "span", "engine.fold.map": "span",
    "engine.fold.sort": "span", "engine.fold.reduce": "span", "engine.fold.drain": "span",
    "stream.read": "span", "stream.wait": "span", "engine.host_syncs": "counter",
}

KW = dict(block_lines=64, line_width=128, key_width=16, emits_per_line=8, sort_mode="hash")
LINES = [b"alpha beta gamma delta", b"beta gamma", b"epsilon alpha alpha zeta"] * 70


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def test_registry_is_the_jax_registry():
    """Every JAX name is the port's with its kind; the port adds exactly
    its own section."""
    assert {k: tnames.NAMES.get(k) for k in jnames.NAMES} == jnames.NAMES
    assert {k: v for k, v in tnames.NAMES.items() if k not in jnames.NAMES} == PORT_ONLY
    assert list(tnames.NAMES)[-len(PORT_ONLY):] == list(PORT_ONLY)
    assert tnames.METRIC_KINDS == jnames.METRIC_KINDS


def test_span_event_metrics_roundtrip_and_both_schemas(tmp_path):
    t = obs.enable(process="unit")
    with obs.span("cli.run", phase="outer"):
        with obs.span("cli.load", torch.zeros(3)):  # a CPU ref: nothing to sync
            pass
        obs.event("ckpt.mark", generation=7)
    obs.metric_inc("stream.blocks", 3)
    obs.metric_set("job.workers", 2)
    obs.metric_observe("stream.stall_ms", 1.25)
    obs.metric_observe("stream.stall_ms", 0.75)
    doc = obs.export(str(tmp_path / "t.trace.json"))
    validate_trace(doc)
    jvalidate(doc)
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    outer, inner = spans["cli.run"], spans["cli.load"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert doc["otherData"]["trace_id"] == t.trace_id
    assert json.load(open(tmp_path / "t.trace.json")) == doc
    # The same calls on the JAX metrics give the same snapshot.
    jm = jobs.Metrics()
    jm.inc("stream.blocks", 3)
    jm.set("job.workers", 2)
    jm.observe("stream.stall_ms", 1.25)
    jm.observe("stream.stall_ms", 0.75)
    assert doc["otherData"]["metrics"] == jm.snapshot()


@pytest.mark.parametrize("doc", [
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 0, "tid": 0}],
     "otherData": {"trace_id": "x", "clock": "epoch_us"}},
    {"traceEvents": [{"name": "a", "ph": "i", "pid": 0, "tid": 0}],
     "otherData": {"trace_id": "x", "clock": "epoch_us"}},
    {"traceEvents": [{"name": "a", "ph": "Q", "pid": 0, "tid": 0, "ts": 1}],
     "otherData": {"trace_id": "x", "clock": "epoch_us"}},
    {"traceEvents": [], "otherData": {"trace_id": "x", "clock": "tsc"}},
    {"traceEvents": [{"name": 3, "ph": "M", "pid": True, "tid": 0}],
     "otherData": {"trace_id": "x", "clock": "epoch_us"}},
    {"otherData": {"trace_id": "x", "clock": "epoch_us"}},
])
def test_schema_rejects_what_the_jax_schema_rejects(doc):
    with pytest.raises(ValueError) as theirs:
        jvalidate(doc)
    with pytest.raises(ValueError) as ours:
        validate_trace(doc)
    assert str(ours.value).split(":", 1)[1] == str(theirs.value).split(":", 1)[1]


def test_closed_registry_ingest_and_scoping():
    t = obs.enable(process="master")
    with pytest.raises(ValueError, match="not in the obs NAMES registry"):
        t.span("no.such.name")
    with pytest.raises(ValueError, match="kind mismatch"):
        t.event("cli.run")
    with pytest.raises(ValueError, match="kind mismatch"):
        obs.Metrics().observe("stream.blocks", 1.0)  # a counter, observed as a histogram
    w = obs.Tracer(trace_id=t.trace_id, process="worker:1")
    with obs.scoped(w):
        with obs.span("worker.map", shard=0):
            pass
        obs.metric_inc("stream.blocks")  # request-scoped: not the process's
    with obs.scoped(None):
        assert obs.span("cli.run") is obs.span("cli.load") is obs.trace.NULL_SPAN
    assert t.ingest(w.serialize(), offset_s=2.0, process="worker a") == 1
    assert t.ingest([{"ph": "X"}, "junk", {"ph": "X", "ts": float("nan"), "dur": 1.0},
                     {"ph": "X", "ts": 1.0, "dur": "long"}]) == 0
    merged = [e for e in t.to_chrome()["traceEvents"] if e["name"] == "worker.map"]
    assert len(merged) == 1 and merged[0]["pid"] != 0
    assert obs.summary()["metrics"]["counters"] == {}


def test_spans_carry_their_parent_per_thread():
    """A span names the innermost span open on its own thread when it
    opened; a root span names none; another thread's spans are roots."""
    import threading

    t = obs.enable()
    with obs.span("cli.run"):
        with obs.span("engine.fold.block", i=0):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
            with obs.span("engine.fold.map"):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
                pass
            with obs.span("engine.fold.sort"):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
                pass
        th = threading.Thread(target=lambda: obs.span("stream.read").__enter__().__exit__())  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
        th.start()
        th.join(timeout=10)
    got = {name: args.get("parent") for name, _, _, _, args in t.spans()}
    assert got == {"engine.fold.map": "engine.fold.block", "engine.fold.sort": "engine.fold.block",
                   "engine.fold.block": "cli.run", "stream.read": None, "cli.run": None}
    doc = t.to_chrome()
    validate_trace(doc)
    jvalidate(doc)


def test_clock_is_perf_counter_and_exports_through_the_anchor():
    """Spans are stamped on ``perf_counter`` (the accessor's seconds lie
    inside the caller's own readings, in order); the export maps them to
    epoch microseconds through the one anchor pair, and a tracer that
    ingests the serialized list reads the same times back."""
    import threading

    t = obs.enable(process="unit")
    p0, e0 = time.perf_counter(), time.time()
    for i in range(5):
        with obs.span("engine.fold.block", i=i):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
            pass
    p1, e1 = time.perf_counter(), time.time()
    spans = t.spans()
    assert [a["i"] for _, _, _, _, a in spans] == list(range(5))
    assert all(p0 <= s0 <= s1 <= p1 for _, s0, s1, _, _ in spans)
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))  # monotonic
    assert t.spans(thread=threading.get_ident()) == spans
    assert t.spans(thread=-1) == []
    doc = t.to_chrome()
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    for (_, s0, s1, _, _), e in zip(spans, xs):
        want = (s0 - t._anchor_perf_ns / 1e9) * 1e6 + t._anchor_epoch_ns / 1e3
        assert abs(e["ts"] - want) < 1 and abs(e["dur"] - (s1 - s0) * 1e6) < 0.11
        assert e0 * 1e6 - 2e3 <= e["ts"] <= e1 * 1e6 + 2e3
    validate_trace(doc)
    jvalidate(doc)
    other = obs.Tracer(process="master")
    assert other.ingest(t.serialize(), offset_s=0.0, process="unit") == 5
    back = [e for e in other.to_chrome()["traceEvents"] if e["ph"] == "X"]
    assert [(round(e["ts"]), e["dur"]) for e in back] == [(round(e["ts"]), e["dur"]) for e in xs]


@pytest.mark.parametrize("ranges", [False, True])
def test_profiler_ranges_put_the_spans_in_the_profilers_export(ranges, tmp_path):
    """With ``profiler_ranges`` each span is also a profiler range of its
    name; without it the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile

    t = obs.enable()
    t.profiler_ranges = ranges
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("engine.fold.block", i=0):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
            with obs.span("engine.fold.sort"):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
                torch.sort(torch.arange(64).flip(0))
    prof.export_chrome_trace(str(tmp_path / "p.json"))
    events = json.load(open(tmp_path / "p.json"))["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    spans = {"engine.fold.block", "engine.fold.sort"}
    assert names & spans == (spans if ranges else set())
    assert [n for n, *_ in t.spans()] == ["engine.fold.sort", "engine.fold.block"]


def test_span_syncs_cuda_refs_at_exit_only(monkeypatch):
    """A span's sync refs on a CUDA device are synchronised when it
    exits; CPU refs are not (checked without a card: a stand-in ref)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))
    obs.enable()
    cuda_ref = types.SimpleNamespace(device=torch.device("cuda", 0))
    with obs.span("engine.stage.map", cuda_ref, torch.ones(1)):
        assert synced == []
    assert synced == [torch.device("cuda", 0)]
    with obs.span("engine.stage.map"):
        pass
    assert len(synced) == 1


def test_disabled_path_allocates_nothing_and_costs_little():
    assert obs.current() is None
    s = obs.span("stream.block", i=0)
    assert s is obs.span("engine.stage.map") is obs.trace.NULL_SPAN
    assert obs.span("engine.fold.block", i=0) is obs.span("stream.read") is obs.trace.NULL_SPAN  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
    assert obs.event("stream.stall", ms=0.0) is None
    assert obs.metric_inc("stream.blocks") is None
    assert obs.metric_inc("engine.host_syncs") is None  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
    assert obs.export("unused") is None and obs.metrics_snapshot() == {}
    n = 20_000
    t0 = time.perf_counter()
    for i in range(n):
        # What one block of the fold and the stream emits.
        with obs.span("stream.block", i=i, staging="ring"):
            pass
        with obs.span("engine.fold.block", i=i):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
            with obs.span("engine.fold.map"):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
                pass
            with obs.span("engine.fold.sort"):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
                pass
            with obs.span("engine.fold.reduce"):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
                pass
        with obs.span("stream.read"):  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
            pass
        obs.event("stream.stall", block=i, ms=0.0)
        obs.metric_inc("stream.blocks")
        obs.metric_inc("engine.host_syncs")  # locust: noqa[R009] a port-only name (locust_tpu_torch/obs/names.py), not in the JAX registry this rule reads
        obs.metric_observe("stream.stall_ms", 0.0)
    per_block_s = (time.perf_counter() - t0) / n
    eng = TEngine(TConfig(**KW), device="cpu")
    rows = eng.rows_from_lines(LINES[:64])
    t0 = time.perf_counter()
    eng.run(rows)
    fold_s = time.perf_counter() - t0
    assert per_block_s < 50e-6 and per_block_s / fold_s < 0.05, (per_block_s, fold_s)


def _recorded(pkg_obs, run, port_only: dict | None = None) -> dict:
    """{name: count} of the spans, events and metrics ``run`` records
    under JAX-registered names; the port's own names go to ``port_only``."""
    t = pkg_obs.enable()
    run()
    doc = t.to_chrome(pkg_obs.metrics_snapshot())
    names = collections.Counter(e["name"] for e in doc["traceEvents"] if e["ph"] != "M")
    m = doc["otherData"]["metrics"]
    names.update({f"metric {k}": v for k, v in m["counters"].items()})
    names.update({f"metric {k}": h["count"] for k, h in m["histograms"].items()})
    pkg_obs.disable()
    own = {k: names.pop(k) for k in list(names)
           if k.removeprefix("metric ") in PORT_ONLY}
    if port_only is not None:
        port_only.update(own)
    return dict(names)


@pytest.fixture(scope="module")
def engines():
    return JEngine(JConfig(**KW)), TEngine(TConfig(**KW), device="cpu")


def test_timed_run_records_the_jax_engine_spans(engines):
    jeng, teng = engines
    rows = teng.rows_from_lines(LINES)  # 210 lines: 4 blocks
    want = _recorded(jobs, lambda: jeng.timed_run(rows))
    own = {}
    got = _recorded(obs, lambda: teng.timed_run(rows), own)
    assert got == want
    assert got["engine.stage.merge"] == 4
    # Its stages call the sort and reduce themselves, so no fold span; per
    # block 4 stage syncs and the overflow's read, at the end the
    # distinct count's.
    assert own == {"metric engine.host_syncs": 4 * 5 + 1}


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_run_stream_records_the_jax_engine_spans_and_events(engines, tmp_path, async_ckpt):
    """Eight blocks, a snapshot every 3: stream.block per block, a
    stream.stall per block past the dispatch depth, ckpt.mark at blocks
    3, 6 and 8 with their counters.  In the loop (sync) every mark is
    published; on the writer thread (async) a mark may be skipped, so
    there ckpt.write and ckpt.publish are held to the writer's count."""
    rows = engines[1].rows_from_lines(LINES * 3)[:8 * 64]
    blocks = [rows[i:i + 64] for i in range(0, len(rows), 64)]
    jeng = JEngine(JConfig(**KW, async_checkpoint=async_ckpt))
    teng = TEngine(TConfig(**KW, async_checkpoint=async_ckpt), device="cpu")
    kw = dict(every=3, fingerprint="f")
    want = _recorded(jobs, lambda: jeng.run_stream(iter(blocks), checkpoint_dir=str(tmp_path / "j"), **kw))
    res = []
    own = {}
    got = _recorded(obs, lambda: res.append(
        teng.run_stream(iter(blocks), checkpoint_dir=str(tmp_path / "t"), **kw)), own)
    if async_ckpt:
        writer = {k: got.pop(k, 0) for k in ("ckpt.write", "ckpt.publish", "ckpt.skip")}
        for k in ("ckpt.write", "ckpt.publish", "ckpt.skip"):
            want.pop(k, None)
        ckpt = res[0].stream["ckpt"]
        assert writer["ckpt.write"] == writer["ckpt.publish"] == ckpt["written"]
        assert writer["ckpt.skip"] == ckpt["skipped"]
    assert got == want
    assert got["stream.block"] == 8 and got["stream.stall"] == 4 and got["ckpt.mark"] == 3
    assert got["metric stream.blocks"] == 8 and got["metric ckpt.marks"] == 3
    # The port's own: 8 blocks staged and folded, the reader's 8 pulls and
    # the one that finds the end, at most as many waits; 4 backpressure
    # waits, the closing sync and the two counters' reads.
    waits = own.pop("stream.wait", 0)
    assert 0 <= waits <= 9
    assert own == {"engine.stage_blocks": 8, "engine.fold.map": 8, "engine.fold.sort": 8,
                   "engine.fold.reduce": 8, "engine.fold.drain": 1, "stream.read": 9,
                   "metric engine.host_syncs": 4 + 1 + 2}


def test_engine_config_trace_enables_the_process_tracer():
    assert obs.current() is None
    eng = TEngine(TConfig(**KW, trace=True), device="cpu")
    assert obs.current() is not None
    eng.timed_run(eng.rows_from_lines([b"a b a"]))
    names = {e["name"] for e in obs.current().to_chrome()["traceEvents"]}
    assert "engine.stage.process" in names
    assert obs.summary()["spans"] == 4  # one span per stage of the one block
