"""PyTorch port, engine: ``run``, ``run_fused``, ``timed_run`` and
``run_lines`` held against the JAX engine with ``use_pallas=True,
sort_mode="bitonic"`` (both Pallas kernels in interpret mode).  Exact
equality; tables are compared bit for bit under the asserted
precondition that no two distinct keys of the corpus share a folded sort
key."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os

import numpy as np
import pytest
import torch

from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.engine import MapReduceEngine as JEngine
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.engine import MapReduceEngine as TEngine
from locust_tpu_torch.io.loader import load_lines, load_rows
from locust_tpu_torch.ops.process_stage import _folded_key
from locust_tpu_torch.state import table_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "sample_corpus.txt")
CFG = dict(block_lines=64, line_width=128, emits_per_line=8, key_width=16,
           use_pallas=True, sort_mode="bitonic", table_size=2048)
METHODS = ("run", "run_fused", "timed_run", "run_lines")


@pytest.fixture(scope="module")
def rows():
    return load_rows(CORPUS, 128)


@pytest.fixture(scope="module")
def jax_engine():
    return JEngine(JConfig(**CFG))


@pytest.fixture(scope="module")
def jax_results(jax_engine, rows):
    out = {}
    for m in METHODS:
        arg = load_lines(CORPUS) if m == "run_lines" else rows
        out[m] = getattr(jax_engine, m)(arg)
    return out


def _arg(method, rows):
    return load_lines(CORPUS) if method == "run_lines" else rows


def _assert_same_result(t, j):
    assert t.to_host_pairs() == j.to_host_pairs()
    assert t.num_segments == j.num_segments
    assert t.overflow_tokens == j.overflow_tokens
    assert t.truncated == j.truncated
    lanes, values, valid = table_to_numpy(t.table)
    assert np.array_equal(lanes, np.asarray(j.table.key_lanes))
    assert np.array_equal(values, np.asarray(j.table.values))
    assert np.array_equal(valid, np.asarray(j.table.valid))


def test_corpus_has_no_folded_key_collision(rows):
    """The precondition of the bit-for-bit table comparisons."""
    res = TEngine(TConfig(**CFG), device="cpu").run(rows)
    table = res.table
    folded = _folded_key(table)[table.valid]
    assert len(torch.unique(folded)) == int(table.valid.sum()) == res.num_segments


@pytest.mark.parametrize("method", METHODS)
def test_engine_equals_jax(method, rows, jax_results):
    eng = TEngine(TConfig(**CFG), device="cpu")
    res = getattr(eng, method)(_arg(method, rows))
    _assert_same_result(res, jax_results[method])
    assert res.overflow_tokens > 0 and not res.truncated
    if method == "timed_run":
        assert min(res.times.map_ms, res.times.process_ms, res.times.reduce_ms) > 0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_map_route_and_sort_mode_do_not_change_host_pairs(use_pallas, rows, jax_results):
    cfg = TConfig(**dict(CFG, use_pallas=use_pallas, sort_mode="hashp1"))
    res = TEngine(cfg, device="cpu").run_fused(rows)
    _assert_same_result(res, jax_results["run_fused"])


def test_empty_input_equals_jax(jax_engine):
    empty = np.zeros((0, 128), np.uint8)
    j = jax_engine.run(empty)
    t = TEngine(TConfig(**CFG), device="cpu").run(empty)
    _assert_same_result(t, j)
    assert t.to_host_pairs() == []


def test_count_combine_equals_sum_of_ones(rows, jax_results):
    res = TEngine(TConfig(**CFG), combine="count", device="cpu").run(rows)
    assert res.to_host_pairs() == jax_results["run"].to_host_pairs()
