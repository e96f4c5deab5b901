"""PyTorch port, the fold graph (locust_tpu_torch/fold_graph.py): which
folds engage it, and that a run through it gives the eager fold's table,
counters and launch counts, with nothing the caller keeps aliasing the
graph's buffers.

On the CPU, which has no CUDA graphs, a ``FoldGraph`` runs its step
eagerly over the same static buffers, so the engine's graph path (the
buffers' chaining, the clones, the checkpoint pump's copies) is held
against the eager path here with the rule forced on.  The ``cuda`` tests
capture and replay on a card and skip without one; on the card run
``python -m pytest --noconftest tests/test_torch_fold_graph.py`` (the
suite's conftest imports JAX, which the card's machine lacks)."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from locust_tpu_torch import engine as engine_mod
from locust_tpu_torch import fold_graph, obs
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.engine import MapReduceEngine
from locust_tpu_torch.io.corpus import synthetic_corpus
from locust_tpu_torch.ops.kernels.sort import bitonic_sort_rows
from locust_tpu_torch.ops.kernels.tokenize import tokenize_block_kernel
from locust_tpu_torch.ops.map_stage import wordcount_map

CPU_CFG = EngineConfig(block_lines=64, line_width=128, key_width=16, emits_per_line=8,
                       table_size=1024, sort_mode="bitonic", use_pallas=True)
# The cells' configuration: the CLI's defaults with kernels A and B.
CARD_CFG = EngineConfig(sort_mode="bitonic", use_pallas=True)


def _rows(cfg: EngineConfig, nbytes: int, seed: int) -> np.ndarray:
    """A Zipf corpus of about ``nbytes`` over 600 words, every 40th line
    past the emit cap (so the overflow counter moves in every block), and
    a partial last block."""
    lines = synthetic_corpus(nbytes, n_vocab=600, seed=seed)
    long_line = b" ".join(b"x%d" % i for i in range(cfg.emits_per_line + 3))
    lines = [long_line if i % 40 == 0 else ln for i, ln in enumerate(lines)]
    if len(lines) % cfg.block_lines == 0:
        lines.append(b"tail")
    return bytes_ops.strings_to_rows(lines, cfg.line_width)


def _host_blocks(rows: np.ndarray, cfg: EngineConfig):
    return [rows[i:i + cfg.block_lines] for i in range(0, rows.shape[0], cfg.block_lines)]


def _state(res) -> tuple:
    t = res.table
    return (t.key_lanes.cpu().numpy().tobytes(), t.values.cpu().numpy().tobytes(),
            t.valid.cpu().numpy().tobytes(), res.num_segments, res.overflow_tokens,
            res.truncated)


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.disable()
    yield
    obs.disable()


@pytest.fixture
def graphs(monkeypatch):
    """A fresh graph cache for the test."""
    cache = fold_graph.FoldGraphs()
    monkeypatch.setattr(fold_graph, "GRAPHS", cache)
    return cache


def _force(monkeypatch) -> None:
    """The graph's rule forced on, over a fresh cache: the CPU then folds
    through ``FoldGraph``."""
    monkeypatch.setattr(fold_graph, "GRAPHS", fold_graph.FoldGraphs())
    monkeypatch.setattr(fold_graph, "eligible", lambda cfg, map_fn, device: (True, ""))


def _eager(monkeypatch) -> None:
    monkeypatch.setattr(fold_graph, "eligible", lambda cfg, map_fn, device: (False, "test"))


@pytest.fixture
def forced(monkeypatch):
    _force(monkeypatch)


def _upper_map(lines, cfg):
    return wordcount_map(lines, cfg)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("cfg, map_fn, device, why", [
    (CPU_CFG, wordcount_map, torch.device("cpu"), "the device is cpu"),
    (dataclasses.replace(CPU_CFG, sort_mode="hasht"), wordcount_map, CUDA, "sort_mode='hasht'"),
    (dataclasses.replace(CPU_CFG, sort_mode="hasht-mxu"), wordcount_map, CUDA,
     "sort_mode='hasht-mxu'"),
    (dataclasses.replace(CPU_CFG, sort_mode="fused"), wordcount_map, CUDA, "sort_mode='fused'"),
    (dataclasses.replace(CPU_CFG, sort_mode="hash"), wordcount_map, CUDA, "sort_mode='hash'"),
    (CPU_CFG, _upper_map, CUDA, "map_fn is not the wordcount tokenizer"),
    (dataclasses.replace(CPU_CFG, use_pallas=False), wordcount_map, CUDA, "use_pallas is off"),
])
def test_the_rule_keeps_other_folds_eager(cfg, map_fn, device, why):
    ok, reason = fold_graph.eligible(cfg, map_fn, device)
    assert not ok and reason.startswith(why)


def test_the_rule_engages_bitonic_wordcount_on_a_cuda_device_without_launching():
    assert fold_graph.eligible(CPU_CFG, wordcount_map, CUDA) == (True, "")
    assert fold_graph.eligible(CARD_CFG, wordcount_map, torch.device("cuda", 1)) == (True, "")


def test_a_cpu_engine_folds_eagerly(caplog):
    with caplog.at_level("INFO", logger="locust_tpu_torch"):
        eng = MapReduceEngine(CPU_CFG, device="cpu")
    assert eng._graph_key is None
    assert "fold graph not engaged — the device is cpu" in caplog.text


@pytest.mark.parametrize("combine", ["sum", "count", "min", "max"])
def test_forced_graph_run_fused_equals_the_eager_fold(monkeypatch, combine):
    rows = _rows(CPU_CFG, 20_000, seed=1)
    _eager(monkeypatch)
    want = _state(MapReduceEngine(CPU_CFG, combine=combine, device="cpu").run_fused(rows))
    _force(monkeypatch)
    obs.enable()
    got = _state(MapReduceEngine(CPU_CFG, combine=combine, device="cpu").run_fused(rows))
    counters = obs.metrics_snapshot()["counters"]
    assert got == want and want[4] > 0  # the overflow moved
    assert counters["engine.fold.graph_replays"] == -(-rows.shape[0] // CPU_CFG.block_lines)


def test_forced_graph_keeps_each_runs_table_its_own(forced):
    """A run's table and counters are clones: the next run, which folds
    through the same graph's buffers, leaves them as they were."""
    eng = MapReduceEngine(CPU_CFG, device="cpu")
    first = eng.run_fused(_rows(CPU_CFG, 20_000, seed=2))
    kept = _state(first)
    (graph,) = fold_graph.GRAPHS._free[eng._graph_key]
    second = MapReduceEngine(CPU_CFG, device="cpu").run_fused(_rows(CPU_CFG, 20_000, seed=3))
    assert _state(first) == kept != _state(second)
    buffers = {graph.table.key_lanes.data_ptr(), graph.table.values.data_ptr(),
               graph.table.valid.data_ptr()}
    for res in (first, second):
        t = res.table
        assert buffers.isdisjoint({t.key_lanes.data_ptr(), t.values.data_ptr(),
                                   t.valid.data_ptr()})
    assert fold_graph.GRAPHS._free[eng._graph_key] == [graph]  # held and handed back


def test_forced_graph_run_batch_and_carried_table_equal_the_eager_fold(monkeypatch):
    cfg, bl = CPU_CFG, CPU_CFG.block_lines
    jobs = np.stack([np.stack([np.pad(b, ((0, bl - b.shape[0]), (0, 0)))
                               for b in _host_blocks(_rows(cfg, 20_000, seed=s), cfg)][:3])
                     for s in (4, 5)])
    rows = _rows(cfg, 9_000, seed=6)
    base = MapReduceEngine(cfg, device="cpu").run_fused(_rows(cfg, 5_000, seed=7)).table

    def both():
        eng = MapReduceEngine(cfg, device="cpu")
        return [_state(r) for r in eng.run_batch(jobs)] + [_state(eng.run(rows, acc=base))]

    _eager(monkeypatch)
    want = both()
    _force(monkeypatch)
    got = both()
    assert got == want and want[0] != want[1]


@pytest.mark.parametrize("async_checkpoint", [None, False, True])
def test_forced_graph_run_stream_equals_the_eager_fold(monkeypatch, tmp_path, async_checkpoint):
    """With a checkpoint pump, a run stopped mid-way resumes from its
    snapshot to the eager fold's answer: the snapshot's counters are
    those of its table, though the writer saves them while later folds
    go on (slowed here so that they do)."""
    rows = _rows(CPU_CFG, 60_000, seed=8)
    blocks = _host_blocks(rows, CPU_CFG)
    cfg = CPU_CFG if async_checkpoint is None else dataclasses.replace(
        CPU_CFG, async_checkpoint=async_checkpoint)
    _eager(monkeypatch)
    want = _state(MapReduceEngine(cfg, device="cpu").run_stream(blocks))
    _force(monkeypatch)
    write = engine_mod._write_marked

    def slow_write(*args):
        time.sleep(0.05)
        write(*args)

    monkeypatch.setattr(engine_mod, "_write_marked", slow_write)
    eng = MapReduceEngine(cfg, device="cpu")
    if async_checkpoint is None:
        assert _state(eng.run_stream(blocks)) == want
        return

    class Stop(Exception):
        pass

    def dying():
        for i, b in enumerate(blocks):
            if i == 7:
                raise Stop
            yield b

    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Stop):
        eng.run_stream(dying(), checkpoint_dir=ckpt, every=2, fingerprint="fp")
    assert os.path.exists(os.path.join(ckpt, "state.npz"))
    res = eng.run_stream(blocks, checkpoint_dir=ckpt, every=2, fingerprint="fp")
    assert res.stream["blocks"] < len(blocks)  # resumed
    assert _state(res) == want and want[4] > 0


def test_timed_run_and_run_checkpointed_stay_eager(forced, tmp_path):
    rows = _rows(CPU_CFG, 8_000, seed=9)
    eng = MapReduceEngine(CPU_CFG, device="cpu")
    obs.enable()
    eng.timed_run(rows)
    eng.run_checkpointed(rows, str(tmp_path / "ck"))
    assert "engine.fold.graph_replays" not in obs.metrics_snapshot()["counters"]


@pytest.mark.parametrize("mode", ["hash", "hashp", "hashp2", "hashp1", "hash1", "radix",
                                  "bitonic", "lex", "hasht"])
def test_fold_block_into_out_returns_its_tensors_and_the_same_table(mode):
    """``fold_block(acc, lines, out=t)`` writes the table into ``t`` (the
    hasht family by a copy of the table it builds anew), also where ``t``
    is ``acc`` itself, as the fold graph passes it: bit for bit the
    table, overflow and distinct count of the fold without ``out``."""
    cfg = dataclasses.replace(CPU_CFG, sort_mode=mode)
    eng = MapReduceEngine(cfg, device="cpu")
    first, second = (torch.from_numpy(np.pad(b, ((0, cfg.block_lines - b.shape[0]), (0, 0))))
                     for b in _host_blocks(_rows(cfg, 9_000, seed=12), cfg)[:2])
    acc = eng.fold_block(eng.empty_table(), first)[0]
    want = eng.fold_block(acc, second)

    def bits(res):
        table, overflow, distinct = res
        return [t.numpy().tobytes() for t in table.tensors()] + [int(overflow), int(distinct)]

    alias = acc.clone()
    for acc, out in ((acc, eng.empty_table()), (alias, alias)):
        got = eng.fold_block(acc, second, out=out)
        assert all(g is o for g, o in zip(got[0].tensors(), out.tensors()))
        assert bits(got) == bits(want) and int(want[2]) > 0


@pytest.mark.parametrize("how", ["run_fused", "run_stream"])
def test_forced_graph_calls_the_class_fold_block_once_a_block(forced, monkeypatch, how):
    """The graph's step is ``MapReduceEngine.fold_block``: a wrapper of
    it on the class sees every block of the forced-graph path, with
    ``out`` the graph's table, and the pooled graph keeps no engine."""
    rows = _rows(CPU_CFG, 20_000, seed=13)
    blocks = _host_blocks(rows, CPU_CFG)
    calls, real = [], MapReduceEngine.fold_block

    def fold_block(self, acc, lines, **kw):
        calls.append(kw)
        return real(self, acc, lines, **kw)

    monkeypatch.setattr(MapReduceEngine, "fold_block", fold_block)
    eng = MapReduceEngine(CPU_CFG, device="cpu")
    res = eng.run_fused(rows) if how == "run_fused" else eng.run_stream(blocks)
    (graph,) = fold_graph.GRAPHS._free[eng._graph_key]
    assert len(calls) == len(blocks) and all(kw["out"] is not None for kw in calls)
    assert graph.fold_block is None
    monkeypatch.setattr(MapReduceEngine, "fold_block", real)
    _eager(monkeypatch)
    assert _state(res) == _state(MapReduceEngine(CPU_CFG, device="cpu").run_fused(rows))


# ------------------------------------------------------------- on a card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fold graph captures and replays there")
    return torch.device("cuda")


def _card_run(how: str, cfg: EngineConfig, rows: np.ndarray, tmp_path):
    """``(states, launches, counters, span names)`` of one way of folding
    ``rows``."""
    launches0 = (tokenize_block_kernel.launches, bitonic_sort_rows.launches)
    obs.enable()
    eng = MapReduceEngine(cfg)
    blocks = _host_blocks(rows, cfg)
    if how == "run_fused":
        out = [eng.run_fused(rows)]
    elif how == "run_stream":
        out = [eng.run_stream(blocks)]
    elif how == "run_stream_async_ckpt":
        out = [eng.run_stream(blocks, checkpoint_dir=str(tmp_path / "ck"), every=3,
                              fingerprint="fp")]
    elif how == "run_batch":
        bl = cfg.block_lines
        padded = np.stack([np.pad(b, ((0, bl - b.shape[0]), (0, 0))) for b in blocks])
        out = eng.run_batch(np.stack([padded, padded[::-1].copy()]))
    torch.cuda.synchronize()
    counters = obs.metrics_snapshot()["counters"]
    spans = {name for name, *_ in obs.current().spans()}
    obs.disable()
    launches = (tokenize_block_kernel.launches - launches0[0],
                bitonic_sort_rows.launches - launches0[1])
    return [_state(r) for r in out], launches, counters, spans


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["run_fused", "run_stream", "run_stream_async_ckpt",
                                 "run_batch"])
def test_card_graph_tables_and_launches_equal_the_eager_fold(card, graphs, monkeypatch,
                                                             tmp_path, how):
    rows = _rows(CARD_CFG, 2_000_000, seed=10)
    nblocks = -(-rows.shape[0] // CARD_CFG.block_lines)
    folds = 2 * nblocks if how == "run_batch" else nblocks
    first = _card_run(how, CARD_CFG, rows, tmp_path / "g1")
    again = _card_run(how, CARD_CFG, rows, tmp_path / "g2")
    _eager(monkeypatch)
    want = _card_run(how, CARD_CFG, rows, tmp_path / "e")
    assert want[2].get("engine.fold.graph_replays") is None
    assert first[0] == again[0] == want[0]
    assert first[1] == again[1] == want[1] == (folds, folds)
    assert first[2]["engine.fold.graph_captures"] == 1
    assert "engine.fold.graph_captures" not in again[2]
    assert first[2]["engine.fold.graph_replays"] == again[2]["engine.fold.graph_replays"] == folds
    assert "engine.fold.map" in want[3] and "engine.fold.map" not in again[3]
    assert "engine.fold.capture" in first[3] and "engine.fold.capture" not in again[3]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hasht", "hasht-mxu", "fused", "timed_run", "map_fn"])
def test_card_other_folds_stay_eager(card, graphs, mode):
    rows = _rows(CARD_CFG, 1_000_000, seed=11)
    obs.enable()
    if mode == "timed_run":
        MapReduceEngine(CARD_CFG).timed_run(rows)
    elif mode == "map_fn":
        MapReduceEngine(CARD_CFG, map_fn=_upper_map).run_fused(rows)
    else:
        MapReduceEngine(dataclasses.replace(CARD_CFG, sort_mode=mode)).run_fused(rows)
    counters = obs.metrics_snapshot()["counters"]
    assert "engine.fold.graph_replays" not in counters
    assert "engine.fold.graph_captures" not in counters
    assert not graphs._free


@pytest.mark.cuda
def test_card_graph_captures_the_class_fold_block_and_never_calls_it_in_a_replay(
        card, graphs, monkeypatch, tmp_path):
    rows = _rows(CARD_CFG, 2_000_000, seed=14)
    calls, real = [], MapReduceEngine.fold_block

    def fold_block(self, acc, lines, **kw):
        calls.append(torch.cuda.is_current_stream_capturing())
        return real(self, acc, lines, **kw)

    monkeypatch.setattr(MapReduceEngine, "fold_block", fold_block)
    first = _card_run("run_fused", CARD_CFG, rows, tmp_path / "g1")
    again = _card_run("run_fused", CARD_CFG, rows, tmp_path / "g2")
    assert calls == [False, True]  # the warm-up, then the capture
    monkeypatch.setattr(MapReduceEngine, "fold_block", real)
    _eager(monkeypatch)
    want = _card_run("run_fused", CARD_CFG, rows, tmp_path / "e")
    assert first[0] == again[0] == want[0]
    assert first[2]["engine.fold.graph_replays"] == -(-rows.shape[0] // CARD_CFG.block_lines) > 2
