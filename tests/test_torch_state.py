"""PyTorch port, state carried across packages and capacity: JAX folds
the first blocks (or writes a ``run_checkpointed`` snapshot), the port
continues from that table, and the answer is JAX's whole run; a table
smaller than the corpus's distinct keys truncates exactly as in JAX.
Exact equality throughout."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os

import numpy as np
import pytest
import torch

from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.engine import MapReduceEngine as JEngine
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.engine import MapReduceEngine as TEngine
from locust_tpu_torch.engine import merge_host_pairs
from locust_tpu_torch.io.loader import load_rows
from locust_tpu_torch.state import load_jax_checkpoint, table_from_jax, table_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "sample_corpus.txt")
CFG = dict(block_lines=64, line_width=128, emits_per_line=8, key_width=16,
           use_pallas=True, sort_mode="bitonic", table_size=2048)


@pytest.fixture(scope="module")
def rows():
    return load_rows(CORPUS, 128)


@pytest.fixture(scope="module")
def jax_engine():
    return JEngine(JConfig(**CFG))


@pytest.fixture(scope="module")
def jax_results(jax_engine, rows):
    return {"run": jax_engine.run(rows)}


def _assert_same_result(t, j):
    assert t.to_host_pairs() == j.to_host_pairs()
    assert t.num_segments == j.num_segments
    assert t.overflow_tokens == j.overflow_tokens
    assert t.truncated == j.truncated
    lanes, values, valid = table_to_numpy(t.table)
    assert np.array_equal(lanes, np.asarray(j.table.key_lanes))
    assert np.array_equal(values, np.asarray(j.table.values))
    assert np.array_equal(valid, np.asarray(j.table.valid))


def test_truncation_equals_jax(rows):
    cfg = dict(CFG, table_size=512)
    j = JEngine(JConfig(**cfg)).run(rows)
    t = TEngine(TConfig(**cfg), device="cpu").run(rows)
    assert t.truncated and t.num_segments == 512
    _assert_same_result(t, j)


@pytest.mark.parametrize("k_blocks", [1, 7])
def test_state_carry_from_jax(k_blocks, rows, jax_engine, jax_results):
    """JAX folds the first k blocks; the port continues from its table."""
    cut = k_blocks * CFG["block_lines"]
    head = jax_engine.run(rows[:cut])
    lanes, values, valid = (np.asarray(x) for x in (head.table.key_lanes, head.table.values, head.table.valid))
    acc = table_from_jax(lanes, values, valid, "cpu")
    back = table_to_numpy(acc)
    assert back[0].dtype == np.uint32 and np.array_equal(back[0], lanes)
    t = TEngine(TConfig(**CFG), device="cpu").run(rows[cut:], acc=acc)
    whole = jax_results["run"]
    assert t.to_host_pairs() == whole.to_host_pairs()
    assert t.num_segments == whole.num_segments
    assert head.overflow_tokens + t.overflow_tokens == whole.overflow_tokens
    assert merge_host_pairs(head.to_host_pairs(), TEngine(TConfig(**CFG), device="cpu")
                            .run(rows[cut:]).to_host_pairs()) == whole.to_host_pairs()


def test_load_jax_checkpoint_and_continue(tmp_path, rows, jax_engine, jax_results):
    """A snapshot that the JAX engine's run_checkpointed wrote resumes in
    the port."""
    cut_blocks = 6
    jax_engine.run_checkpointed(rows[: cut_blocks * CFG["block_lines"]], str(tmp_path), every=4)
    snap = load_jax_checkpoint(str(tmp_path / "state.npz"), "cpu")
    assert snap.next_block == cut_blocks and isinstance(snap.acc, KVBatch)
    assert snap.acc.key_lanes.dtype == torch.int32
    t = TEngine(TConfig(**CFG), device="cpu").run(
        rows[snap.next_block * CFG["block_lines"]:], acc=snap.acc
    )
    whole = jax_results["run"]
    assert t.to_host_pairs() == whole.to_host_pairs()
    assert snap.overflow + t.overflow_tokens == whole.overflow_tokens
    assert max(snap.max_distinct, t.num_segments) == whole.num_segments
