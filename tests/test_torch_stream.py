"""PyTorch port, the bounded-memory and crash-resumable runners against
the JAX engine: ``run_stream`` (staging ring on and off; under ``fused``
one kernel call per segment of 1, 2 or 8 blocks, and a flagged segment
re-folded whole), ``run_batch`` and ``run_checkpointed``, and crash /
resume inside the port and across the packages both ways (a snapshot
written by one package, interrupted at block k, resumed by the other).

Tables are compared bit for bit, with ``num_segments``, overflow and the
``stream`` report's keys.  The port's ``fused`` stream is held against
JAX's ``hasht`` stream: the JAX package pins its own ``fused`` stream
bit-identical to ``hasht`` (tests/test_fused_fold.py), and its
interpret-mode kernel would cost this file a minute.  No two distinct
keys of the corpus share a folded hash (tests/test_torch_engine.py).
"""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os

import numpy as np
import pytest
import torch

from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.config import fused_stream_seg_blocks as jseg_blocks
from locust_tpu.engine import MapReduceEngine as JEngine
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.config import fused_stream_seg_blocks as tseg_blocks
from locust_tpu_torch.engine import MapReduceEngine as TEngine
from locust_tpu_torch.io.loader import load_rows
from locust_tpu_torch.ops.kernels import fused_fold as tfused
from locust_tpu_torch.state import load_jax_checkpoint, table_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "sample_corpus.txt")
BL = 64
CFG = dict(block_lines=BL, line_width=128, emits_per_line=8, key_width=16, table_size=2048)
# The JAX run_stream report's keys (locust_tpu/engine.py:829-839, :954-969).
STREAM_KEYS = {"blocks", "staging_ring", "donate_fold", "backpressure_stall_ms", "total_ms"}
FUSED_KEYS = {"formulation", "seg_blocks", "segments", "interpret"}
ASYNC_CKPT_KEYS = {"mode", "mark_ms", "submitted", "written", "skipped", "abandoned",
                   "max_lag", "every", "final_flush_ms"}


@pytest.fixture(scope="module")
def rows():
    return load_rows(CORPUS, 128)  # 820 lines: 13 blocks


def _blocks(rows):
    return [rows[i:i + BL] for i in range(0, len(rows), BL)]


@pytest.fixture(scope="module")
def jax_engines():
    return {mode: JEngine(JConfig(**CFG, sort_mode=mode)) for mode in ("hash", "hasht")}


@pytest.fixture(scope="module")
def jax_stream(jax_engines, rows):
    return {mode: eng.run_stream(iter(_blocks(rows))) for mode, eng in jax_engines.items()}


def _assert_same(t, j, min_segments=1000):
    assert t.num_segments == j.num_segments > min_segments
    assert t.overflow_tokens == j.overflow_tokens > 0
    assert t.truncated == j.truncated
    lanes, values, valid = table_to_numpy(t.table)
    assert np.array_equal(lanes, np.asarray(j.table.key_lanes))
    assert np.array_equal(values, np.asarray(j.table.values))
    assert np.array_equal(valid, np.asarray(j.table.valid))
    assert t.to_host_pairs() == j.to_host_pairs()


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("mode", ["hash", "hasht"])
def test_run_stream_equals_jax(mode, ring, rows, jax_stream):
    eng = TEngine(TConfig(**CFG, sort_mode=mode, stream_staging_ring=ring), device="cpu")
    t = eng.run_stream(iter(_blocks(rows)))
    j = jax_stream[mode]
    _assert_same(t, j)
    assert set(t.stream) == set(j.stream) == STREAM_KEYS
    assert t.stream["blocks"] == j.stream["blocks"] == 13
    assert t.stream["staging_ring"] is ring and t.fused_kernel is None


def test_fused_segment_length_equals_jax():
    for epb, bl in ((512, 64), (81920, 4096), ((1 << 24) - 1, 64), (1 << 20, 1 << 14)):
        assert tseg_blocks(epb, bl, False) == jseg_blocks(epb, bl, False)
        assert tseg_blocks(epb, bl, True) == jseg_blocks(epb, bl, True)
    cfg = dict(CFG, sort_mode="fused")
    assert TEngine(TConfig(**cfg), device="cpu")._fused_stream_seg == \
        JEngine(JConfig(**cfg))._fused_stream_seg == 8


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("seg", [1, 2, 8])
def test_run_stream_fused_one_kernel_call_per_segment(seg, ring, rows, jax_stream, monkeypatch):
    calls = []
    real = tfused.fused_preagg_reference
    monkeypatch.setattr(tfused, "fused_preagg_reference",
                        lambda lines, *a, **kw: calls.append(lines.shape[0]) or real(lines, *a, **kw))
    eng = TEngine(TConfig(**CFG, sort_mode="fused", stream_staging_ring=ring), device="cpu")
    eng._fused_stream_seg = seg
    t = eng.run_stream(iter(_blocks(rows)))
    _assert_same(t, jax_stream["hasht"])
    n_seg = -(-13 // seg)
    assert calls == [seg * BL] * n_seg  # the trailing segment zero-padded
    assert t.fused_refolds == 0 and not t.fused_demoted
    if seg == 1:  # block by block, as JAX folds when its clamp gives 1
        assert t.fused_kernel == "batch" and set(t.stream) == STREAM_KEYS
    else:
        assert t.fused_kernel == "stream" and set(t.stream) == STREAM_KEYS | {"fused"}
        assert t.stream["fused"] == {"formulation": "stream", "seg_blocks": seg,
                                     "segments": n_seg, "interpret": True}
        assert set(t.stream["fused"]) == FUSED_KEYS


def test_run_stream_flagged_segment_refolds_whole(rows, jax_stream, monkeypatch):
    """A 16-slot kernel table: every segment's tiles strand more keys than
    their residual rows hold, and each segment folds again, whole, through
    the stock path (one map over the segment's lines)."""
    monkeypatch.setattr(tfused, "FUSED_TABLE_SLOTS", 16)
    eng = TEngine(TConfig(**CFG, sort_mode="fused"), device="cpu")
    maps = []
    real_map = eng.map_fn
    eng.map_fn = lambda lines, cfg: maps.append(lines.shape[0]) or real_map(lines, cfg)
    t = eng.run_stream(iter(_blocks(rows)))
    _assert_same(t, jax_stream["hasht"])
    assert t.fused_refolds == t.stream["fused"]["segments"] == 2
    assert maps == [8 * BL, 8 * BL]


def test_run_batch_equals_jax(rows, jax_engines):
    """Three jobs, two slices of the corpus and an all-zero job, in one
    ``[njobs, nblocks, block_lines, width]`` stack."""
    jeng = jax_engines["hash"]
    a, b = jeng.prepare_blocks(rows[:384]), jeng.prepare_blocks(rows[384:768])
    stack = np.stack([np.asarray(a), np.asarray(b), np.zeros_like(np.asarray(a))])
    want = jeng.run_batch(stack)
    for mode in ("hash", "fused"):
        teng = TEngine(TConfig(**CFG, sort_mode=mode), device="cpu")
        got = teng.run_batch(stack)
        assert len(got) == 3
        for job, (t, j) in enumerate(zip(got[:2], want[:2])):
            if mode == "hash":
                _assert_same(t, j, min_segments=500)
            assert t.to_host_pairs() == j.to_host_pairs()
            assert t.num_segments == j.num_segments and t.overflow_tokens == j.overflow_tokens
            assert t.to_host_pairs() == teng.run_fused(rows[384 * job:384 * (job + 1)]).to_host_pairs()
        empty = got[2]
        assert empty.num_segments == want[2].num_segments == 0
        assert not empty.table.valid.any() and empty.to_host_pairs() == []


# -------------------------------------------------------- crash and resume


class _Crash(RuntimeError):
    pass


def _dying(items, after):
    for i, item in enumerate(items):
        if i == after:
            raise _Crash(f"stopped after block {after}")
        yield item


def _stream(eng, rows, ckpt, after=None):
    items = _blocks(rows) if after is None else _dying(_blocks(rows), after)
    return eng.run_stream(items, checkpoint_dir=str(ckpt), every=3, fingerprint="sample-corpus")


def _checkpointed(eng, rows, ckpt, after=None):
    if after is None:
        return eng.run_checkpointed(rows, str(ckpt), every=3)
    name = "_fold_block" if isinstance(eng, JEngine) else "fold_block"
    real = getattr(eng, name)
    calls = []

    def fold(acc, lines):
        if len(calls) == after:
            raise _Crash(f"stopped after block {after}")
        calls.append(1)
        return real(acc, lines)

    setattr(eng, name, fold)
    try:
        return eng.run_checkpointed(rows, str(ckpt), every=3)
    finally:
        setattr(eng, name, real)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax"), ("torch", "torch")])
@pytest.mark.parametrize("runner", [_stream, _checkpointed], ids=["run_stream", "run_checkpointed"])
def test_crash_resume_across_packages(runner, writer, reader, rows, jax_engines, jax_stream, tmp_path):
    engines = {"jax": jax_engines["hash"],
               "torch": TEngine(TConfig(**CFG, sort_mode="hash"), device="cpu")}
    assert repr(engines["torch"].cfg) == repr(engines["jax"].cfg)  # the fingerprint's part
    with pytest.raises(_Crash):
        runner(engines[writer], rows, tmp_path, after=7)
    snap = load_jax_checkpoint(str(tmp_path / "state.npz"), "cpu")
    assert snap.next_block == 6  # the last mark before the crash
    res = runner(engines[reader], rows, tmp_path)
    whole = jax_stream["hash"]
    if reader == "torch":
        _assert_same(res, whole)
    else:
        assert res.to_host_pairs() == whole.to_host_pairs()
        assert res.num_segments == whole.num_segments
        assert res.overflow_tokens == whole.overflow_tokens
        assert np.array_equal(np.asarray(res.table.key_lanes), np.asarray(whole.table.key_lanes))
    if runner is _stream:  # the resumed run folds only the blocks after the snapshot
        assert res.stream["blocks"] == 13 - 6
        assert set(res.stream["ckpt"]) == ASYNC_CKPT_KEYS
    assert load_jax_checkpoint(str(tmp_path / "state.npz"), "cpu").next_block == 13


def test_stream_fused_crash_resume_and_checkpoint_report(rows, jax_engines, jax_stream, tmp_path):
    """Under ``fused`` the marks land on segment ends; a resume re-forms
    segments from the restored cursor and the table is JAX's ``hasht``
    table.  The checkpoint report has the JAX writer's keys."""
    eng = TEngine(TConfig(**CFG, sort_mode="fused"), device="cpu")
    eng._fused_stream_seg = 2
    with pytest.raises(_Crash):
        _stream(eng, rows, tmp_path, after=9)
    assert load_jax_checkpoint(str(tmp_path / "state.npz"), "cpu").next_block == 8
    res = _stream(eng, rows, tmp_path)
    _assert_same(res, jax_stream["hasht"])
    assert res.stream["blocks"] == 5 and res.stream["fused"]["segments"] == 3
    j = jax_engines["hash"].run_stream(iter(_blocks(rows)), checkpoint_dir=str(tmp_path / "j"),
                                       every=3, fingerprint="x")
    assert set(res.stream["ckpt"]) == set(j.stream["ckpt"]) == ASYNC_CKPT_KEYS
    assert res.stream["ckpt"]["mode"] == "async" and res.stream["ckpt"]["written"] >= 1
    sync = TEngine(TConfig(**CFG, sort_mode="hash", async_checkpoint=False), device="cpu")
    s = _stream(sync, rows, tmp_path / "s")
    assert s.stream["ckpt"]["mode"] == "sync" and s.stream["ckpt"]["written"] == 5
    assert set(s.stream["ckpt"]) == {"mode", "mark_ms", "written", "every", "final_flush_ms"}


def test_foreign_or_garbled_snapshot_starts_fresh(rows, jax_stream, tmp_path):
    eng = TEngine(TConfig(**CFG, sort_mode="hash"), device="cpu")
    eng.run_checkpointed(rows[:200], str(tmp_path), every=3)  # another corpus
    _assert_same(eng.run_checkpointed(rows, str(tmp_path), every=3), jax_stream["hash"])
    (tmp_path / "state.npz").write_bytes(b"not an npz")
    res = _stream(eng, rows, tmp_path)
    _assert_same(res, jax_stream["hash"])
    assert res.stream["blocks"] == 13
    with pytest.raises(ValueError, match="fingerprint"):
        eng.run_stream(iter(_blocks(rows)), checkpoint_dir=str(tmp_path))
