"""PyTorch port, chaos: the distributor and the backend breaker under
injected faults.

The port's counterparts of the distributor and backend tests of
tests/test_faults.py (WorkerHealth and the heartbeat, the chaos matrix,
the data plane's defaults, the breaker's run) and of the breaker tests
of tests/test_backend.py.  For every fault class the plan can inject
into a distributed job, the job either ends byte-identical to the JAX
one-shot CLI or raises a structured ``MasterError``, within small
bounded timeouts.  The port's ``CircuitBreaker`` agrees with JAX's call
for call.  Its breaker run differs from JAX's by design: JAX fails over
to the CPU, the port reloads its snapshot on the same device and waits
for the half-open probe; both are oracle-exact and trip alike.
"""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import contextlib
import os
import threading
import time

import numpy as np
import pytest

from locust_tpu import backend as jbackend
from locust_tpu import obs as jax_obs
from locust_tpu.config import EngineConfig as JEngineConfig
from locust_tpu.core import bytes_ops as jbytes
from locust_tpu.engine import MapReduceEngine as JEngine
from locust_tpu.utils import faultplan as jfaultplan
from locust_tpu_torch import backend
from locust_tpu_torch import obs
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.distributor import master
from locust_tpu_torch.distributor.master import (
    JobResult,
    MasterError,
    WorkerHealth,
)
from locust_tpu_torch.distributor.worker import Worker
from locust_tpu_torch.engine import MapReduceEngine
from locust_tpu_torch.io import serde
from locust_tpu_torch.ops.kernels import KernelLaunchError
from locust_tpu_torch.utils import faultplan
from test_torch_distributor import jax_oneshot, make_inproc_runner, reduce_bytes

SECRET = b"chaos-secret"

CORPUS = b"""alpha beta gamma
beta gamma delta
gamma delta epsilon
delta epsilon alpha
epsilon alpha beta
zeta eta theta iota
"""

# Small, bounded control-plane timings: a hung test IS a failed test.
WORKER_KW = dict(secret=SECRET, conn_timeout=3.0)
JOB_KW = dict(rpc_timeout=15.0, heartbeat_interval=0.2, poll_s=0.02, max_retries=2)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    """A chaos plan must never leak across tests."""
    yield
    faultplan.deactivate()
    jfaultplan.deactivate()


@pytest.fixture
def corpus_file(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(CORPUS)
    return str(p)


@pytest.fixture(scope="module")
def jax_cache():
    return {}


@pytest.fixture
def want(corpus_file, capsysbinary, jax_cache):
    """The JAX one-shot CLI's bytes for CORPUS (computed once per module)."""
    if "want" not in jax_cache:
        jax_cache["want"] = jax_oneshot(corpus_file, capsysbinary)
    return jax_cache["want"]


def _shutdown(w: Worker):
    try:
        master._rpc(w.addr, {"cmd": "shutdown"}, SECRET, timeout=5)
    except Exception:
        pass


def _run_wordcount(corpus_file, tmp_path, capsysbinary, plan=None, n_workers=2,
                   job_kw=None, rpc=None):
    """Full loopback job (optionally under a fault plan) -> (bytes, JobResult)."""
    workers = [Worker(map_runner=make_inproc_runner(), **WORKER_KW) for _ in range(n_workers)]
    for w in workers:
        w.serve_in_thread()
    kw = dict(JOB_KW, **(job_kw or {}))
    # Fast, fresh health per job: short backoffs keep the matrix quick
    # without changing the scheduling logic under test.
    kw.setdefault("health", WorkerHealth(n_workers, base_s=0.05, cap_s=2.0, seed=1))
    if rpc is not None:
        kw["rpc"] = rpc
    try:
        with faultplan.active_plan(plan) if plan is not None else contextlib.nullcontext():
            res = master.run_job([w.addr for w in workers], corpus_file, SECRET,
                                 workdir=str(tmp_path / "m"), **kw)
        return reduce_bytes(corpus_file, res, capsysbinary), res
    finally:
        for w in workers:
            _shutdown(w)


def plan(rules, seed=7) -> faultplan.FaultPlan:
    return faultplan.FaultPlan(rules, seed=seed)


# ---------------------------------------------------- health unit (fake clock)


class FakeClock:
    def __init__(self, t=0.0, step=0.0):
        self.t = t
        self.step = step  # advanced on every read (a deterministic run clock)

    def __call__(self):
        self.t += self.step
        return self.t

    def advance(self, dt):
        self.t += dt


def test_worker_health_exponential_backoff_fake_clock():
    clk = FakeClock()
    h = WorkerHealth(2, clock=clk, base_s=1.0, cap_s=8.0, jitter=0.0, seed=1)
    assert h.healthy(0) and not h.quarantined(0)
    assert h.fail(0) == 1.0
    assert h.quarantined(0) and not h.probe_due(0) and not h.healthy(0)
    clk.advance(0.5)
    assert not h.probe_due(0)
    clk.advance(0.6)
    assert h.probe_due(0)        # backoff expired: eligible for a probe
    assert not h.healthy(0)      # ...but NOT healthy until a good pong
    assert [h.fail(0) for _ in range(4)] == [2.0, 4.0, 8.0, 8.0]  # doubles, capped
    h.ok(0)
    assert h.healthy(0) and h.failures(0) == 0
    assert h.fail(0) == 1.0
    assert h.healthy(1)


def test_worker_health_jitter_deterministic_bounded_and_equal_to_jax():
    from locust_tpu.distributor.master import WorkerHealth as JWorkerHealth

    clk = FakeClock()
    a = WorkerHealth(1, clock=clk, base_s=1.0, jitter=0.5, seed=3)
    b = WorkerHealth(1, clock=clk, base_s=1.0, jitter=0.5, seed=3)
    j = JWorkerHealth(1, clock=clk, base_s=1.0, jitter=0.5, seed=3)
    backs = [a.fail(0) for _ in range(4)]
    assert backs == [b.fail(0) for _ in range(4)]  # seeded, reproducible
    assert backs == [j.fail(0) for _ in range(4)]  # the JAX master's noise, bit for bit
    for i, back in enumerate(backs):
        base = min(8.0 * 4, 1.0 * 2**i)
        assert base <= back <= base * 1.5  # jitter stretches, never shrinks
    c = WorkerHealth(1, clock=clk, base_s=1.0, jitter=0.5, seed=4)
    assert [c.fail(0) for _ in range(4)] != backs


def _heartbeat(h, rpc, until):
    stop = threading.Event()
    t = threading.Thread(target=master._heartbeat_loop,
                         args=(stop, h, [("127.0.0.1", 1)], rpc, SECRET, 0.02), daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while not until() and time.monotonic() < deadline:
        time.sleep(0.01)
    stop.set()
    t.join(timeout=2)
    assert not t.is_alive()


def test_heartbeat_unquarantines_recovered_worker():
    h = WorkerHealth(1, base_s=0.01, jitter=0.0)
    h.fail(0)
    pings = []

    def rpc(node, req, secret):
        pings.append(req["cmd"])
        return {"status": "ok", "pong": True}

    _heartbeat(h, rpc, lambda: h.healthy(0))
    assert h.healthy(0), "heartbeat should un-quarantine on a good pong"
    assert "ping" in pings


def test_heartbeat_deepens_backoff_while_down():
    h = WorkerHealth(1, base_s=0.01, jitter=0.0)
    h.fail(0)

    def rpc(node, req, secret):
        raise ConnectionRefusedError("still down")

    _heartbeat(h, rpc, lambda: h.failures(0) >= 3)
    assert h.failures(0) >= 3 and not h.healthy(0)


# ------------------------------------------------------------- chaos matrix


@pytest.mark.parametrize("rules,fired", [
    # Refuse the first two connects anywhere: the shard fails over.
    ([{"site": "rpc.connect", "action": "refuse", "times": 2}], 2),
    # One corrupted map frame: the HMAC rejects it, the connection drops,
    # the shard is retried.
    ([{"site": "rpc.frame", "action": "corrupt", "match": {"cmd": "map"}, "times": 1}], 1),
    # One truncated map frame: the worker's bounded read times out (3 s),
    # it answers a structured error, the shard is retried.
    ([{"site": "rpc.frame", "action": "truncate", "match": {"cmd": "map"}, "times": 1}], 1),
    # One map fails with a structured error.
    ([{"site": "worker.map", "action": "error", "match": {"shard": 1}, "times": 1}], 1),
    # The encoded payload rots after the worker hashed the raw window:
    # a zlib error or a chunk-sha mismatch, the shard re-runs.
    ([{"site": "io.chunk", "action": "corrupt", "times": 1}], 1),
    ([{"site": "io.chunk", "action": "truncate", "times": 1}], 1),
    # A stalled chunk delays the transfer but never changes the bytes.
    ([{"site": "io.chunk", "action": "delay", "times": 1, "delay_s": 1.0}], 1),
], ids=["connect_refusal", "frame_corruption", "frame_truncation", "map_error",
        "compressed_chunk_corruption", "chunk_truncation", "chunk_delay"])
def test_chaos_byte_identical(rules, fired, corpus_file, tmp_path, capsysbinary, want):
    p = plan(rules)
    out, res = _run_wordcount(corpus_file, tmp_path, capsysbinary, plan=p)
    assert out == want
    assert p.rules[0].fired == fired


def test_chaos_worker_crash_mid_map_byte_identical(corpus_file, tmp_path, capsysbinary, want):
    """Shard 0's first map attempt dies like a SIGKILL (connection dropped,
    no reply); the master reassigns it."""
    p = plan([{"site": "worker.map", "action": "crash", "match": {"shard": 0}, "times": 1}])
    out, res = _run_wordcount(corpus_file, tmp_path, capsysbinary, plan=p)
    assert out == want
    shard0 = next(s for s in res.shards if s.shard == 0)
    assert len(shard0.attempts) >= 2  # the crash cost an attempt


def test_chaos_straggler_speculative_backup_wins(corpus_file, tmp_path, capsysbinary, want):
    """Shard 1's first map attempt stalls 12 s; the speculative backup on
    the other worker wins long before the stall ends."""
    p = plan([{"site": "rpc.delay", "action": "delay", "match": {"cmd": "map", "shard": 1},
               "times": 1, "delay_s": 12.0}])
    t0 = time.monotonic()
    out, res = _run_wordcount(corpus_file, tmp_path, capsysbinary, plan=p,
                              job_kw=dict(speculate_after=0.4))
    elapsed = time.monotonic() - t0
    assert out == want
    shard1 = next(s for s in res.shards if s.shard == 1)
    assert shard1.speculated, "straggling shard should have speculated"
    assert shard1.attempts[0]["outcome"] == "cancelled"  # the stalled primary lost
    assert next(a for a in shard1.attempts if a["outcome"] == "ok")["speculative"]
    assert elapsed < 11.0


def test_chaos_intermediate_corruption_byte_identical(corpus_file, tmp_path, capsysbinary,
                                                      want):
    """One fetch chunk rots on 'disk': the end-to-end sha256 recorded at
    map time catches it, the worker is quarantined, the shard re-runs."""
    p = plan([{"site": "io.intermediate", "action": "corrupt", "times": 1}])
    out, res = _run_wordcount(corpus_file, tmp_path, capsysbinary, plan=p)
    assert out == want
    assert p.rules[0].fired == 1
    assert "integrity" in [a["outcome"] for s in res.shards for a in s.attempts]


@pytest.mark.parametrize("rules,match", [
    ([{"site": "rpc.connect", "action": "refuse"}], "failed on every tried"),
    ([{"site": "io.intermediate", "action": "corrupt"}], None),
    ([{"site": "io.chunk", "action": "corrupt"}], None),
], ids=["everything_down", "persistent_corruption", "persistent_chunk_corruption"])
def test_chaos_structured_error(rules, match, corpus_file, tmp_path):
    """Faults on EVERY attempt (no ``times`` cap): the job fails FAST with
    a structured MasterError, never a hang or silent corruption."""
    workers = [Worker(map_runner=make_inproc_runner(), **WORKER_KW) for _ in range(2)]
    for w in workers:
        w.serve_in_thread()
    p = plan(rules)
    try:
        t0 = time.monotonic()
        with faultplan.active_plan(p):
            with pytest.raises(MasterError, match=match):
                master.run_job([w.addr for w in workers], corpus_file, SECRET,
                               workdir=str(tmp_path / "m"),
                               health=WorkerHealth(2, base_s=0.05, cap_s=0.5, seed=1),
                               **JOB_KW)
        assert time.monotonic() - t0 < 30.0
        assert p.rules[0].fired >= 1
    finally:
        for w in workers:
            _shutdown(w)


def test_dataplane_defaults_binary_packed(corpus_file, tmp_path, capsysbinary, want):
    """The binary data plane is the default: packed-KV intermediates over
    binary frames, per-fetch stats in JobResult.shards."""
    out, res = _run_wordcount(corpus_file, tmp_path, capsysbinary)
    assert out == want
    assert all(serde.is_kvbin(p) for p in res)
    dp = res.dataplane()
    assert dp["binary"] and dp["fetches"] == 2 and dp["payload_bytes"] > 0
    for s in res.shards:
        f = next(a for a in s.attempts if a["outcome"] == "ok")["fetch"]
        assert f["bytes"] > 0 and f["chunks"] >= 1 and f["binary"]
        assert f["elapsed_s"] > 0 and f["wire_bytes"] > 0


def test_master_detects_tampered_chunk_via_chunk_digest(corpus_file, tmp_path, capsysbinary,
                                                        want):
    """Per-chunk sha256: a chunk tampered BETWEEN worker and master (after
    the worker hashed it) is caught, and the shard reassigned."""
    import base64

    tampered = {"n": 0}

    def tampering_rpc(node, req, secret):
        resp = master._rpc(node, req, secret, timeout=JOB_KW["rpc_timeout"])
        if req.get("cmd") == "fetch" and tampered["n"] == 0 and resp.get("data_b64"):
            raw = bytearray(base64.b64decode(resp["data_b64"]))
            raw[0] ^= 0xFF
            resp["data_b64"] = base64.b64encode(bytes(raw)).decode()
            tampered["n"] += 1
        return resp

    out, res = _run_wordcount(corpus_file, tmp_path, capsysbinary, rpc=tampering_rpc)
    assert out == want
    assert tampered["n"] == 1
    assert "integrity" in [a["outcome"] for s in res.shards for a in s.attempts]


def test_job_result_is_still_a_path_list(corpus_file, tmp_path, capsysbinary, want):
    """JobResult behaves as the list of intermediate paths, with the
    per-shard timing stats riding along."""
    out, res = _run_wordcount(corpus_file, tmp_path, capsysbinary)
    assert out == want
    assert isinstance(res, JobResult) and isinstance(res, list)
    assert len(res) == 2 and all(os.path.exists(t) for t in res)
    assert len(res.shards) == 2 and res.timeline() is None  # telemetry was off
    for s in res.shards:
        assert s.winner is not None and s.elapsed_s > 0
        assert s.attempts and s.attempts[0]["t1"] is not None
        assert s.as_dict()["shard"] == s.shard


# ---------------------------------------------------------- backend breaker


def _breaker(threshold=3, cooldown_s=30.0, mod=backend):
    clk = FakeClock(t=1000.0)
    return mod.CircuitBreaker(threshold=threshold, cooldown_s=cooldown_s, clock=clk), clk


def test_breaker_trips_after_consecutive_failures_only():
    br, _ = _breaker(threshold=3)
    br.record_failure()
    br.record_failure()
    br.record_success()  # success resets the consecutive count
    br.record_failure()
    br.record_failure()
    assert br.state() == "closed" and br.allow()
    br.record_failure()
    assert br.state() == "open" and not br.allow()
    assert br.stats()["trips"] == 1


def test_breaker_half_open_single_probe_then_close():
    br, clk = _breaker(threshold=1, cooldown_s=10.0)
    br.record_failure()
    assert br.state() == "open" and not br.allow()
    clk.t += 10.0
    assert br.allow()          # the one half-open probe
    assert br.state() == "half_open"
    assert not br.allow()      # concurrent callers wait
    br.record_success()
    assert br.state() == "closed" and br.allow()


def test_breaker_failed_probe_reopens_for_full_cooldown():
    br, clk = _breaker(threshold=1, cooldown_s=10.0)
    br.record_failure()
    clk.t += 10.0
    assert br.allow()
    br.record_failure()        # probe dies: back to open, new cooldown
    assert br.state() == "open"
    clk.t += 9.9
    assert not br.allow()
    clk.t += 0.2
    assert br.allow()
    br.record_success()
    assert br.state() == "closed"
    assert br.stats()["trips"] == 1  # a failed probe re-opens, not re-trips


def test_breaker_rejects_bad_params():
    with pytest.raises(ValueError):
        backend.CircuitBreaker(threshold=0)
    with pytest.raises(ValueError):
        backend.CircuitBreaker(cooldown_s=0.0)


def test_breaker_scripted_sequence_equals_jax():
    """One scripted sequence of allow / record_* calls and clock moves:
    the port's and JAX's breakers pass through the same states, answer
    the same, and end with the same stats()."""
    rng = np.random.default_rng(11)
    ops = rng.choice(["allow", "ok", "fail", "tick"], size=400, p=[0.4, 0.2, 0.3, 0.1])
    pair = (_breaker(2, 5.0), _breaker(2, 5.0, mod=jbackend))
    states = set()
    for step, op in enumerate(ops):
        got = []
        for br, clk in pair:
            answer = None
            if op == "allow":
                answer = br.allow()
            elif op == "ok":
                br.record_success()
            elif op == "fail":
                br.record_failure()
            else:
                clk.advance(3.0)
            got.append((answer, br.state(), br.stats()))
        assert got[0] == got[1], (step, op)
        states.add(got[0][1])
    assert states == {"closed", "open", "half_open"}
    assert got[0][2]["trips"] > 1 and got[0][2]["successes"] > 10


def test_guarded_dispatch_accounts_success_and_failure():
    br, _ = _breaker(threshold=2)
    assert backend.guarded_dispatch(br, lambda: 41 + 1) == 42

    def fail():
        raise KernelLaunchError("tokenizer kernel launch failed: cudaError 700")

    with pytest.raises(KernelLaunchError):
        backend.guarded_dispatch(br, fail)
    st = br.stats()
    assert st["successes"] == 1 and st["failures"] == 1
    assert st["state"] == "closed"  # one failure, threshold two
    p = plan([{"site": "backend.dispatch", "action": "error", "times": 1}])
    with faultplan.active_plan(p):
        with pytest.raises(faultplan.FaultInjected):
            backend.guarded_dispatch(br, lambda: 1, block=0, backend="primary")
    assert br.state() == "open" and br.stats()["trips"] == 1


@pytest.mark.parametrize("err", [OSError("nvcc: build failed"),
                                 ValueError("tokenizer: no kernel for device meta"),
                                 RuntimeError("a bug in a wrapper")])
def test_guarded_dispatch_passes_other_errors_uncounted(err):
    """A failed build or a wrapper's bug is no dispatch failure: it
    propagates, and the breaker counts neither a failure nor a success."""
    br, _ = _breaker(threshold=1)

    def fail():
        raise err

    with pytest.raises(type(err), match=str(err)):
        backend.guarded_dispatch(br, fail)
    assert br.stats() == dict(br.stats(), state="closed", failures=0, successes=0)


# ----------------------------------------------------- the breaker in the engine

BREAKER_LINES = [b"aaa bbb ccc", b"bbb ccc ddd"] * 64  # 32 blocks of 4 lines
CFG_KW = dict(block_lines=4, line_width=64, emits_per_line=8)


@pytest.fixture
def one_thread():
    """One intra-op thread for the CPU folds of 4-line blocks: under a
    loaded test run, a thread pool per process spins on ops this small."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_breaker_run(tmp_path_factory):
    """JAX's run of the breaker scenario under a stepping clock: its
    pairs, the breaker's stats and its backend.* events, once."""
    return _breaker_run(JEngine(JEngineConfig(**CFG_KW)), jbackend, jfaultplan, jax_obs,
                        str(tmp_path_factory.mktemp("jax_breaker")))


def _breaker_run(eng, mod, fp, telemetry, ckpt):
    """``run_checkpointed`` under a ``backend.dispatch`` error plan (3
    failures) with a clock that moves 0.01 s per read, so the cooldown
    ends after a fixed number of breaker calls in either package."""
    rows = jbytes.strings_to_rows(BREAKER_LINES, 64)
    br = mod.CircuitBreaker(threshold=2, cooldown_s=0.05, clock=FakeClock(step=0.01))
    p = fp.FaultPlan([{"site": "backend.dispatch", "action": "error", "times": 3}], seed=7)
    telemetry.enable(process="breaker-test")
    try:
        with fp.active_plan(p):
            res = eng.run_checkpointed(rows, ckpt, every=2, breaker=br)
        doc = telemetry.export(os.path.join(ckpt, "breaker.trace.json"))
    finally:
        telemetry.disable()
    events = [(e["name"], e.get("args")) for e in doc["traceEvents"]
              if e["name"].startswith("backend.")]
    return res.to_host_pairs(), br.stats(), events


def test_breaker_run_trips_like_jax_and_stays_on_device(one_thread, tmp_path,
                                                         jax_breaker_run):
    """The port's run of the scenario: oracle-exact through the trip, the
    failed probe and the recovery, every fold on the engine's device (no
    ``backend.failover``); the same trip, failures and breaker events as
    the JAX run, whose folds between them went to the CPU."""
    eng = MapReduceEngine(EngineConfig(**CFG_KW), device="cpu")
    pairs, stats, events = _breaker_run(eng, backend, faultplan, obs, str(tmp_path / "ck"))
    jpairs, jstats, jevents = jax_breaker_run
    want = eng.run(jbytes.strings_to_rows(BREAKER_LINES, 64)).to_host_pairs()
    assert pairs == want == jpairs
    assert stats == dict(jstats, successes=stats["successes"])
    # Every one of the 32 blocks folded once, each a counted success.
    assert stats == dict(stats, trips=1, failures=3, state="closed", successes=32)
    assert events == [e for e in jevents if e[0] != "backend.failover"]
    assert [n for n, _ in events] == ["backend.breaker_open", "backend.breaker_half_open",
                                      "backend.breaker_open", "backend.breaker_half_open",
                                      "backend.breaker_close"]


def test_chaos_backend_dispatch_breaker_trips_reloads_exact(one_thread, tmp_path):
    """The JAX test's scenario on a real clock: the breaker trips, the run
    reloads its last snapshot, sleeps out the cooldown and finishes on
    its own device, oracle-exact, with the trip on the trace timeline."""
    eng = MapReduceEngine(EngineConfig(**CFG_KW), device="cpu")
    rows = jbytes.strings_to_rows(BREAKER_LINES, 64)
    want = eng.run(rows).to_host_pairs()
    br = backend.CircuitBreaker(threshold=2, cooldown_s=0.05)
    p = plan([{"site": "backend.dispatch", "action": "error", "times": 3}])
    obs.enable(process="breaker-test")
    try:
        with faultplan.active_plan(p):
            t0 = time.monotonic()
            res = eng.run_checkpointed(rows, str(tmp_path / "ck"), every=2, breaker=br)
            waited = time.monotonic() - t0
        doc = obs.export(str(tmp_path / "breaker.trace.json"))
        trips = doc["otherData"]["metrics"]["counters"]["backend.breaker_trips"]
    finally:
        obs.disable()
    assert res.to_host_pairs() == want  # oracle-exact through the trip
    assert res.table.key_lanes.device.type == "cpu"
    st = br.stats()
    assert st == dict(st, trips=1, failures=3, state="closed") and trips == 1
    assert waited >= 2 * 0.05  # two cooldowns slept out: the trip, the failed probe
    names = [e["name"] for e in doc["traceEvents"] if e["name"].startswith("backend.")]
    assert "backend.breaker_open" in names and "backend.failover" not in names


def test_chaos_backend_dispatch_delay_absorbed(one_thread, tmp_path):
    """backend.dispatch delay (a slow dispatch): the run is late but exact,
    and a slow dispatch alone never trips the breaker."""
    eng = MapReduceEngine(EngineConfig(**CFG_KW), device="cpu")
    rows = jbytes.strings_to_rows([b"aaa bbb"] * 16, 64)
    want = eng.run(rows).to_host_pairs()
    br = backend.CircuitBreaker(threshold=2, cooldown_s=5.0)
    p = plan([{"site": "backend.dispatch", "action": "delay", "delay_s": 0.2, "times": 1}])
    t0 = time.monotonic()
    with faultplan.active_plan(p):
        res = eng.run_checkpointed(rows, str(tmp_path / "delay_ck"), every=2, breaker=br)
    assert res.to_host_pairs() == want
    assert time.monotonic() - t0 >= 0.2
    assert p.rules[0].fired == 1
    assert br.state() == "closed" and br.stats() == dict(br.stats(), trips=0, failures=0,
                                                         successes=4)


def test_failed_fold_without_breaker_raises_and_other_errors_pass_the_breaker(
        one_thread, tmp_path, monkeypatch):
    """Without a breaker a failed fold raises; with one, an error that is
    no dispatch failure (a wrapper's bug) raises uncounted.  With no plan
    and a closed breaker, every fold is a counted success on the
    engine's device and no backend.* event fires."""
    eng = MapReduceEngine(EngineConfig(**CFG_KW), device="cpu")
    rows = jbytes.strings_to_rows(BREAKER_LINES, 64)
    real = eng.fold_block
    calls = {"n": 0}

    def flaky(acc, lines):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("fold died")
        return real(acc, lines)

    monkeypatch.setattr(eng, "fold_block", flaky)
    with pytest.raises(RuntimeError, match="fold died"):
        eng.run_checkpointed(rows, str(tmp_path / "a"), every=2)
    br, _ = _breaker(threshold=1)
    calls["n"] = 0
    with pytest.raises(RuntimeError, match="fold died"):
        eng.run_checkpointed(rows, str(tmp_path / "b"), every=2, breaker=br)
    assert br.stats() == dict(br.stats(), state="closed", failures=0, successes=2)
    monkeypatch.setattr(eng, "fold_block", real)
    br = backend.CircuitBreaker(threshold=2, cooldown_s=0.05)
    obs.enable(process="no-failover")
    try:
        res = eng.run_checkpointed(rows, str(tmp_path / "c"), every=2, breaker=br)
        doc = obs.export(str(tmp_path / "c.trace.json"))
    finally:
        obs.disable()
    assert res.to_host_pairs() == eng.run(rows).to_host_pairs()
    assert br.stats() == dict(br.stats(), state="closed", failures=0, successes=32, trips=0)
    assert not [e for e in doc["traceEvents"] if e["name"].startswith("backend.")]


def test_refused_launch_below_threshold_is_refolded_from_the_snapshot(one_thread, tmp_path,
                                                                     monkeypatch):
    """One refused kernel launch mid-run: the breaker stays closed, the
    run reloads the snapshot at once and refolds on the same device,
    oracle-exact."""
    eng = MapReduceEngine(EngineConfig(**CFG_KW), device="cpu")
    rows = jbytes.strings_to_rows(BREAKER_LINES, 64)
    real = eng.fold_block
    calls = {"n": 0}

    def refused_once(acc, lines):
        calls["n"] += 1
        if calls["n"] == 6:
            raise KernelLaunchError("bitonic sort launch failed: cudaError 700")
        return real(acc, lines)

    monkeypatch.setattr(eng, "fold_block", refused_once)
    br = backend.CircuitBreaker(threshold=2, cooldown_s=30.0)
    t0 = time.monotonic()
    res = eng.run_checkpointed(rows, str(tmp_path / "ck"), every=2, breaker=br)
    assert time.monotonic() - t0 < 30.0  # a closed breaker waits for no cooldown
    assert res.to_host_pairs() == eng.run(rows).to_host_pairs()
    # Blocks 0-4 folded, 0-3 checkpointed; block 5's fold died; 4-31 refold.
    assert br.stats() == dict(br.stats(), state="closed", failures=1, trips=0, successes=33)


def test_card_that_keeps_failing_ends_the_breaker_run(one_thread, tmp_path):
    """A dispatch that never comes back: after the trip and
    BREAKER_PROBES failed probes the run raises, naming the failure,
    and never folds elsewhere."""
    from locust_tpu_torch.engine import BREAKER_PROBES

    eng = MapReduceEngine(EngineConfig(**CFG_KW), device="cpu")
    rows = jbytes.strings_to_rows(BREAKER_LINES, 64)
    br = backend.CircuitBreaker(threshold=2, cooldown_s=0.02)
    p = plan([{"site": "backend.dispatch", "action": "error", "times": 100}])
    with faultplan.active_plan(p):
        with pytest.raises(RuntimeError, match="failed 5 times in a row.*FaultInjected"):
            eng.run_checkpointed(rows, str(tmp_path / "ck"), every=2, breaker=br)
    assert p.rules[0].fired == 2 + BREAKER_PROBES
    assert br.stats() == dict(br.stats(), state="open", failures=5, trips=1, successes=0)


def test_breaker_wait_is_bounded_when_the_probe_is_held(one_thread, tmp_path, monkeypatch):
    """The run waits at most one cooldown (plus a second) for the probe:
    a breaker whose clock never reaches the end of the cooldown ends it."""
    eng = MapReduceEngine(EngineConfig(**CFG_KW), device="cpu")
    rows = jbytes.strings_to_rows(BREAKER_LINES, 64)
    br = backend.CircuitBreaker(threshold=1, cooldown_s=0.01, clock=FakeClock(t=0.0))
    p = plan([{"site": "backend.dispatch", "action": "error", "times": 1}])
    with faultplan.active_plan(p):
        with pytest.raises(RuntimeError, match="stayed open past its 0.01 s cooldown"):
            eng.run_checkpointed(rows, str(tmp_path / "ck"), every=2, breaker=br)
    assert br.state() == "open"
