"""PyTorch port, the debug invariant checks (``utils/checks.py``, the
``LOCUST_DEBUG_CHECKS`` sweep of the engine) and the fault plan
(``utils/faultplan.py``, its sites in ``io/snapshot.py``, the CLI's
``--fault-plan``): ``validate_batch`` raises on the JAX function's
corrupt batches, the plan parses, decides and mangles as JAX's does, and
the single-device chaos cases of the JAX suite hold on the port."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.core.kv import KVBatch as JKVBatch
from locust_tpu.utils import checks as jchecks
from locust_tpu.utils import faultplan as jfp
from locust_tpu_torch import engine as tengine
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.engine import MapReduceEngine
from locust_tpu_torch.io.loader import StreamingCorpus
from locust_tpu_torch.utils import checks as tchecks
from locust_tpu_torch.utils import faultplan as tfp

CORPUS = (b"alpha beta gamma\nbeta gamma delta\ngamma delta epsilon\n"
          b"delta epsilon alpha\nepsilon alpha beta\nzeta eta theta iota\n")


def _lanes(*rows):
    return np.array(rows, dtype=np.uint32)


# (name, lanes, valid, kwargs): batches both packages must judge alike.
BATCHES = [
    ("clean sorted compact", _lanes([0x61620000, 0], [0x62000000, 0], [0, 0]),
     [True, True, False], dict(expect_sorted=True, expect_compact=True)),
    ("valid rows not a prefix", _lanes([0x61000000, 0], [0, 0], [0x62000000, 0]),
     [True, False, True], dict(expect_compact=True)),
    ("not a prefix, unchecked", _lanes([0x61000000, 0], [0, 0], [0x62000000, 0]),
     [True, False, True], {}),
    ("out of order", _lanes([0x62000000, 0], [0x61000000, 0]),
     [True, True], dict(expect_sorted=True)),
    ("out of order in the second lane", _lanes([0x61616161, 0x62000000], [0x61616161, 0x61000000]),
     [True, True], dict(expect_sorted=True)),
    ("equal rows", _lanes([0x61000000, 0], [0x61000000, 0]), [True, True],
     dict(expect_sorted=True)),
    ("interior NUL key", _lanes([0x61006200, 0]), [True], {}),
    ("NUL lane then bytes", _lanes([0x61626364, 0], [0x61000000, 0x62000000]), [True, True], {}),
    ("interior NUL in an invalid row", _lanes([0x61006200, 0]), [False], {}),
    # Top-bit lanes: sorted as unsigned (a signed compare flags it).
    ("top bit, sorted unsigned", _lanes([0x7F000000, 0], [0x80000000, 0], [0xFF000000, 0]),
     [True, True, True], dict(expect_sorted=True)),
    # Unsorted as unsigned (a signed compare passes it).
    ("top bit, unsorted unsigned", _lanes([0x80000000, 0], [0x01000000, 0]),
     [True, True], dict(expect_sorted=True)),
    ("empty", np.zeros((0, 2), np.uint32), [], dict(expect_sorted=True, expect_compact=True)),
    ("one lane", _lanes([0xC3A90000]), [True], dict(expect_sorted=True)),
]


def _verdict(fn):
    try:
        fn()
    except AssertionError:
        return "raises"
    return "passes"


@pytest.mark.parametrize("case", range(len(BATCHES)))
def test_validate_batch_judges_as_jax(case):
    _name, lanes, valid, kw = BATCHES[case]
    valid = np.array(valid, bool)
    values = np.arange(len(valid), dtype=np.int32) + 1
    jb = JKVBatch(jnp.asarray(lanes), jnp.asarray(values), jnp.asarray(valid))
    tb = KVBatch(torch.from_numpy(lanes.view(np.int32).copy()), torch.from_numpy(values),
                 torch.from_numpy(valid))
    want = _verdict(lambda: jchecks.validate_batch(jb, **kw))
    assert _verdict(lambda: tchecks.validate_batch(tb, **kw)) == want


def test_validate_batch_top_bit_verdicts():
    """The unsigned order, pinned without the JAX side: a signed compare
    of the int32 bit patterns gets both of these wrong."""
    def batch(*rows):
        lanes = _lanes(*rows).view(np.int32)
        return KVBatch(torch.from_numpy(lanes.copy()), torch.ones(len(rows), dtype=torch.int32),
                       torch.ones(len(rows), dtype=torch.bool))

    tchecks.validate_batch(batch([0x7F000000], [0x80000000]), expect_sorted=True)
    with pytest.raises(AssertionError, match="out of order"):
        tchecks.validate_batch(batch([0x80000000], [0x01000000]), expect_sorted=True)
    with pytest.raises(AssertionError, match="int32"):
        tchecks.validate_batch(KVBatch(torch.zeros((2, 1), dtype=torch.int64),
                                       torch.zeros(2, dtype=torch.int32),
                                       torch.zeros(2, dtype=torch.bool)))


def _rows(lines, cfg):
    return bytes_ops.strings_to_rows(lines, cfg.line_width)


@pytest.mark.parametrize("mode", ["bitonic", "hasht", "fused", "lex"])
def test_debug_checks_sweep_every_result(monkeypatch, mode):
    """With LOCUST_DEBUG_CHECKS set, every result table is checked, the
    valid-prefix layout only for the sort folds."""
    seen = []
    real = tengine.validate_batch

    def recording(batch, **kw):
        seen.append(kw)
        real(batch, **kw)

    monkeypatch.setattr(tengine, "validate_batch", recording)
    cfg = EngineConfig(block_lines=4, line_width=64, emits_per_line=8, sort_mode=mode,
                       use_pallas=True)
    eng = MapReduceEngine(cfg, device="cpu")
    rows = _rows(CORPUS.splitlines() * 3, cfg)
    monkeypatch.delenv("LOCUST_DEBUG_CHECKS", raising=False)
    plain = eng.run_fused(rows).to_host_pairs()
    assert seen == []
    monkeypatch.setenv("LOCUST_DEBUG_CHECKS", "1")
    assert eng.run_fused(rows).to_host_pairs() == plain
    assert eng.timed_run(rows).to_host_pairs() == plain
    compact = mode not in ("hasht", "fused")
    assert seen == [{"expect_compact": compact}] * 2


def test_debug_checks_sweep_raises_on_a_corrupt_table(monkeypatch):
    monkeypatch.setenv("LOCUST_DEBUG_CHECKS", "1")
    eng = MapReduceEngine(EngineConfig(block_lines=4, line_width=64), device="cpu")
    bad = KVBatch(torch.tensor([[0x61006200, 0]], dtype=torch.int32),
                  torch.ones(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool))
    with pytest.raises(AssertionError, match="after NUL"):
        eng._finish(bad, torch.tensor(1), 0, tengine.StageTimes(0, 0, 0))


# ------------------------------------------------------------- fault plan

BAD_PLANS = [
    [{"site": "rpc.conect", "action": "refuse"}],
    [{"site": "rpc.connect", "action": "corrupt"}],
    [{"site": "rpc.connect", "action": "refuse", "portt": 1}],
    [{"site": "rpc.connect", "action": "refuse", "prob": 0.0}],
    [{"site": "rpc.delay", "action": "delay"}],
    [{"site": "io.checkpoint", "action": "truncate", "times": 0}],
]


@pytest.mark.parametrize("case", range(len(BAD_PLANS)))
def test_plan_parse_errors_equal_jax(case):
    spec = json.dumps({"seed": 3, "rules": BAD_PLANS[case]})
    with pytest.raises(ValueError) as t_err:
        tfp.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as j_err:
        jfp.FaultPlan.parse(spec)
    assert str(t_err.value) == str(j_err.value)


def test_plan_registry_and_sources_equal_jax(tmp_path, monkeypatch):
    assert tfp.SITES == jfp.SITES and tfp.ENV_VAR == jfp.ENV_VAR
    spec = '{"seed": 5, "rules": [{"site": "io.ckpt_write", "action": "crash"}]}'
    f = tmp_path / "plan.json"
    f.write_text(spec)
    assert tfp.FaultPlan.parse(str(f)).seed == 5
    assert tfp.FaultPlan.parse('[{"site": "io.checkpoint", "action": "corrupt"}]').seed == 0
    with pytest.raises(ValueError, match="unknown keys"):
        tfp.FaultPlan.parse('{"seed": 1, "rulez": []}')
    monkeypatch.setenv(tfp.ENV_VAR, spec)
    try:
        got = tfp.install()
        assert got is not None and tfp.active() is got
    finally:
        tfp.deactivate()
    monkeypatch.delenv(tfp.ENV_VAR)
    assert tfp.install() is None and tfp.active() is None


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_plan_decisions_and_mutations_equal_jax(seed):
    """The same plan over the same event sequence fires the same rules
    and mangles the same bytes in both packages."""
    spec = [
        {"site": "rpc.frame", "action": "corrupt", "prob": 0.5},
        {"site": "io.checkpoint", "action": "truncate", "after": 2, "times": 3},
        {"site": "io.ckpt_write", "action": "crash", "match": {"generation": 4}},
        {"site": "worker.map", "action": "error", "prob": 0.3, "match": {"shard": 1}},
    ]
    events = [("rpc.frame", {"cmd": "map"}), ("io.checkpoint", {"path": "p"}),
              ("io.ckpt_write", {"path": "p", "generation": 4}),
              ("io.ckpt_write", {"path": "p", "generation": 5}),
              ("worker.map", {"shard": 1}), ("worker.map", {"shard": 0})] * 6
    runs = []
    for mod in (tfp, jfp):
        p = mod.FaultPlan(spec, seed=seed)
        out = []
        with mod.active_plan(p):
            for site, ctx in events:
                if site in ("rpc.frame",):
                    out.append(mod.mangle(site, bytes(range(256)), keep_prefix=4, **ctx))
                else:
                    rule = mod.fire(site, **ctx)
                    out.append(None if rule is None else (rule.index, rule.fired,
                                                          p.mutate(rule, bytes(range(97)))))
        runs.append((out, p.summary()))
    assert runs[0] == runs[1]
    assert any(x not in (None, bytes(range(256))) for x in runs[0][0])


def test_hooks_are_noops_without_a_plan():
    data = b"payload-bytes"
    assert tfp.active() is None
    assert tfp.mangle("io.intermediate", data) is data
    assert tfp.fire("io.ckpt_write", path="p") is None
    tfp.delay("rpc.delay", cmd="map")
    tfp.damage_file("io.checkpoint", "/nonexistent")


# ---------------------------------------- the single-device chaos cases


def _stream_engine(**cfg_kw):
    cfg = EngineConfig(block_lines=4, line_width=64, emits_per_line=8, **cfg_kw)
    return MapReduceEngine(cfg, device="cpu"), cfg


@pytest.fixture
def stream_corpus(tmp_path):
    p = tmp_path / "stream_corpus.txt"
    p.write_bytes(CORPUS * 8)
    return str(p)


def _blocks(path, cfg):
    return StreamingCorpus(path, cfg.line_width, cfg.block_lines)


def test_chaos_async_ckpt_writer_crash_before_rename(tmp_path, stream_corpus):
    eng, cfg = _stream_engine()
    want = dict(eng.run_stream(_blocks(stream_corpus, cfg)).to_host_pairs())
    ck = str(tmp_path / "async_crash_ck")
    fp = _blocks(stream_corpus, cfg).fingerprint()
    p = tfp.FaultPlan([{"site": "io.ckpt_write", "action": "crash", "times": 1}], seed=7)
    with tfp.active_plan(p):
        res = eng.run_stream(_blocks(stream_corpus, cfg), checkpoint_dir=ck, every=1,
                             fingerprint=fp)
    assert dict(res.to_host_pairs()) == want
    assert p.rules[0].fired == 1
    assert res.stream["ckpt"]["mode"] == "async"
    assert res.stream["ckpt"]["abandoned"] == 1
    res2 = eng.run_stream(_blocks(stream_corpus, cfg), checkpoint_dir=ck, every=1,
                          fingerprint=fp)
    assert dict(res2.to_host_pairs()) == want


def test_chaos_async_ckpt_delayed_writer_lapped_generation(tmp_path, stream_corpus):
    # Every publish stalls 1 s, far longer than the loop takes to fold
    # all 12 blocks, even on a loaded machine: the loop laps the writer.
    eng, cfg = _stream_engine()
    want = dict(eng.run_stream(_blocks(stream_corpus, cfg)).to_host_pairs())
    ck = str(tmp_path / "async_delay_ck")
    fp = _blocks(stream_corpus, cfg).fingerprint()
    p = tfp.FaultPlan([{"site": "io.ckpt_write", "action": "delay", "delay_s": 1.0}], seed=7)
    with tfp.active_plan(p):
        res = eng.run_stream(_blocks(stream_corpus, cfg), checkpoint_dir=ck, every=1,
                             fingerprint=fp)
    assert dict(res.to_host_pairs()) == want
    assert p.rules[0].fired >= 1
    cks = res.stream["ckpt"]
    assert cks["skipped"] >= 1 and cks["max_lag"] >= 2
    res2 = eng.run_stream(iter([]), checkpoint_dir=ck, every=1, fingerprint=fp)
    assert dict(res2.to_host_pairs()) == want
    assert res2.num_segments == res.num_segments


def test_chaos_sync_ckpt_write_crash_structured_error(tmp_path, stream_corpus):
    eng, cfg = _stream_engine(async_checkpoint=False)
    want = dict(eng.run_stream(_blocks(stream_corpus, cfg)).to_host_pairs())
    ck = str(tmp_path / "sync_crash_ck")
    fp = _blocks(stream_corpus, cfg).fingerprint()
    p = tfp.FaultPlan([{"site": "io.ckpt_write", "action": "crash", "times": 1}], seed=7)
    with tfp.active_plan(p):
        with pytest.raises(tfp.FaultInjected):
            eng.run_stream(_blocks(stream_corpus, cfg), checkpoint_dir=ck, every=1,
                           fingerprint=fp)
    assert p.rules[0].fired == 1
    res = eng.run_stream(_blocks(stream_corpus, cfg), checkpoint_dir=ck, every=1, fingerprint=fp)
    assert dict(res.to_host_pairs()) == want


def test_chaos_engine_stream_checkpoint_damage_clean_restart(tmp_path, stream_corpus):
    eng, cfg = _stream_engine()
    want = dict(eng.run_stream(_blocks(stream_corpus, cfg)).to_host_pairs())
    ck = str(tmp_path / "damage_ck")
    fp = _blocks(stream_corpus, cfg).fingerprint()
    p = tfp.FaultPlan([{"site": "io.checkpoint", "action": "truncate"}], seed=7)
    with tfp.active_plan(p):
        res = eng.run_stream(_blocks(stream_corpus, cfg), checkpoint_dir=ck, every=1,
                             fingerprint=fp)
    assert dict(res.to_host_pairs()) == want
    assert p.rules[0].fired >= 1
    res2 = eng.run_stream(_blocks(stream_corpus, cfg), checkpoint_dir=ck, every=1, fingerprint=fp)
    assert dict(res2.to_host_pairs()) == want


def test_run_checkpointed_crash_plan_then_resume(tmp_path):
    """run_checkpointed under an io.ckpt_write crash (synchronous writer:
    a structured error), then a clean resume: exact."""
    cfg = EngineConfig(block_lines=4, line_width=64, emits_per_line=8, async_checkpoint=False)
    eng = MapReduceEngine(cfg, device="cpu")
    rows = _rows([b"aaa bbb ccc"] * 32, cfg)
    ck = str(tmp_path / "ck")
    p = tfp.FaultPlan([{"site": "io.ckpt_write", "action": "crash", "after": 2, "times": 1}])
    with tfp.active_plan(p), pytest.raises(tfp.FaultCrash):
        eng.run_checkpointed(rows, ck, every=2)
    assert os.path.exists(os.path.join(ck, "state.npz"))
    res = eng.run_checkpointed(rows, ck, every=2)
    assert dict(res.to_host_pairs()) == {b"aaa": 32, b"bbb": 32, b"ccc": 32}


def test_engine_checkpoint_truncated_clean_restart(tmp_path):
    cfg = EngineConfig(block_lines=4, line_width=64, emits_per_line=8)
    eng = MapReduceEngine(cfg, device="cpu")
    ckpt = str(tmp_path / "eckpt")
    rows = _rows([b"aaa bbb ccc"] * 32, cfg)
    eng.run_checkpointed(rows, ckpt, every=2)
    state = os.path.join(ckpt, "state.npz")
    with open(state, "rb") as f:
        data = f.read()
    with open(state, "wb") as f:
        f.write(data[: len(data) // 3])
    res = eng.run_checkpointed(rows, ckpt, every=2)
    assert dict(res.to_host_pairs()) == {b"aaa": 32, b"bbb": 32, b"ccc": 32}


@pytest.mark.parametrize("via_env", [False, True])
def test_cli_fault_plan(tmp_path, capfdbinary, monkeypatch, via_env):
    """--fault-plan (or $LOCUST_FAULT_PLAN) is live for the run's
    checkpoint writes: the writer crash is injected, the output is the
    clean run's, and the plan is gone after the run."""
    from locust_tpu_torch import cli

    path = tmp_path / "c.txt"
    path.write_bytes(CORPUS * 8)
    base = [str(path), "--stream", "--block-lines", "4", "--backend", "cpu", "--no-timing"]
    assert cli.main(base) == 0
    want = capfdbinary.readouterr().out
    spec = '{"rules": [{"site": "io.ckpt_write", "action": "crash", "times": 1}]}'
    argv = base + ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "1"]
    if via_env:
        monkeypatch.setenv(tfp.ENV_VAR, spec)
    else:
        argv += ["--fault-plan", spec]
    assert cli.main(argv) == 0
    out = capfdbinary.readouterr()
    assert out.out == want
    assert b"'abandoned': 1" in out.err
    assert tfp.active() is None
    with pytest.raises(ValueError, match="unknown site"):
        cli.main(base + ["--fault-plan", '[{"site": "io.nope", "action": "crash"}]'])
