"""PyTorch port, ``sort_mode="fused"`` and the hasht family through the
engine (the fused kernel's plain version itself is held against JAX in
tests/test_torch_fused_fold.py).

The port's ``fused``, ``hasht`` and ``hasht-mxu`` tables are
bit-identical to the JAX ``fused`` and ``hasht`` tables, with equal
``num_segments``, ``overflow_tokens``, ``truncated``, ``fused_kernel`` and
``fused_demoted``, over the sample corpus and seeded random corpora,
including a settlement that leaves its fast path, a truncation and a
kernel table too small for its tiles; and a fold continued from a JAX
``hasht`` table gives JAX's own table.  Exact throughout; bit-identity
holds because no two distinct keys of these corpora share a folded hash
(asserted).
"""

import numpy as np
import pytest
import torch

from helpers import py_wordcount
from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.engine import MapReduceEngine as JEngine
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.core import packing
from locust_tpu_torch.engine import MapReduceEngine as TEngine
from locust_tpu_torch.io.loader import load_lines
from locust_tpu_torch.ops.kernels import fused_fold as tfused
from locust_tpu_torch.state import table_from_jax, table_to_numpy
from test_torch_fused_fold import CORPUS, _vocab_lines


CFG_CORPUS = dict(block_lines=64, key_width=16, emits_per_line=8)


CFG_RANDOM = dict(block_lines=64, key_width=8, emits_per_line=6, table_size=4096)


# A 64-row table: 60 keys leave the settlement's fast path, 300 truncate.
CFG_TIGHT = dict(block_lines=64, key_width=8, emits_per_line=6, table_size=64)


def _random_lines(seed):
    rng = np.random.default_rng(seed)
    vocab = [b"w%d" % i for i in range(120)] + [b"x" * 30, b"hy-phen"]
    return [
        bytes(rng.choice([b" ", b", ", b"; "])).join(
            vocab[j] for j in rng.integers(0, len(vocab), rng.integers(0, 9)))
        for _ in range(200)
    ]


CORPORA = {
    "sample": (CFG_CORPUS, lambda: load_lines(CORPUS)),
    "random0": (CFG_RANDOM, lambda: _random_lines(0)),
    "random1": (CFG_RANDOM, lambda: _random_lines(1)),
    "random2": (CFG_RANDOM, lambda: _random_lines(2)),
    "settle_residual": (CFG_TIGHT, lambda: _vocab_lines(3, 96, 60, 6, b"key")),
    "truncation": (CFG_TIGHT, lambda: [
        b" ".join(b"t%03d" % i for i in range(k, k + 6)) for k in range(0, 294, 2)]),
}


@pytest.fixture(scope="module")
def jax_engines():
    """One JAX engine per (config, mode), built on first use."""
    engines = {}

    def get(cfg_kw, mode):
        key = (tuple(sorted(cfg_kw.items())), mode)
        if key not in engines:
            engines[key] = JEngine(JConfig(sort_mode=mode, **cfg_kw))
        return engines[key]

    return get


def _assert_same_table(t, j):
    lanes, values, valid = table_to_numpy(t.table)
    assert np.array_equal(lanes, np.asarray(j.table.key_lanes))
    assert np.array_equal(values, np.asarray(j.table.values))
    assert np.array_equal(valid, np.asarray(j.table.valid))


def _assert_no_folded_collision(res):
    keys = res.table.key_lanes[res.table.valid]
    assert len(torch.unique(packing.primary_hash(keys) >> 1)) == len(keys)


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_engine_tables_bit_identical_to_jax(corpus, jax_engines):
    cfg_kw, make = CORPORA[corpus]
    lines = make()
    jax_modes = ("fused", "hasht") if corpus in ("sample", "random0") else ("hasht",)
    jres = {m: jax_engines(cfg_kw, m).run_lines(lines) for m in jax_modes}
    for mode in ("fused", "hasht", "hasht-mxu"):
        t = TEngine(TConfig(sort_mode=mode, use_pallas=True, **cfg_kw), device="cpu")
        res = t.run_lines(lines)
        for jm, j in jres.items():
            _assert_same_table(res, j)
            assert (res.num_segments, res.overflow_tokens, res.truncated) == \
                (j.num_segments, j.overflow_tokens, j.truncated), (mode, jm)
            if jm == mode:
                assert (res.fused_kernel, res.fused_demoted) == (j.fused_kernel, j.fused_demoted)
        assert res.fused_kernel == ("batch" if mode == "fused" else None)
        assert res.fused_refolds == 0
    _assert_no_folded_collision(res)
    if corpus == "truncation":
        assert res.truncated
    else:
        assert not res.truncated
        assert dict(res.to_host_pairs()) == dict(py_wordcount(
            [ln[:128] for ln in lines], cfg_kw["emits_per_line"], cfg_kw["key_width"]))


@pytest.mark.parametrize("method", ["run", "run_fused", "timed_run"])
def test_engine_methods_equal_jax_fused(method, jax_engines):
    """Every entry point under "fused"; timed_run runs the split stages
    (the hasht family groups by "hashp1" there), as in JAX."""
    from locust_tpu_torch.io.loader import load_rows

    rows = load_rows(CORPUS, 128)
    j = getattr(jax_engines(CFG_CORPUS, "fused"), method)(rows)
    t = getattr(TEngine(TConfig(sort_mode="fused", use_pallas=True, **CFG_CORPUS),
                        device="cpu"), method)(rows)
    _assert_same_table(t, j)
    assert (t.num_segments, t.overflow_tokens, t.truncated, t.fused_kernel, t.fused_demoted) == \
        (j.num_segments, j.overflow_tokens, j.truncated, j.fused_kernel, j.fused_demoted)


def test_fold_continues_from_a_jax_hasht_table(jax_engines):
    """JAX folds the first blocks under "hasht", the port folds the rest
    under "fused" from that table: JAX's whole-corpus table, bit for bit."""
    from locust_tpu_torch.io.loader import load_rows

    rows = load_rows(CORPUS, 128)
    split = 4 * CFG_CORPUS["block_lines"]
    jeng = jax_engines(CFG_CORPUS, "hasht")
    whole, head = jeng.run(rows), jeng.run(rows[:split])
    acc = table_from_jax(np.asarray(head.table.key_lanes), np.asarray(head.table.values),
                         np.asarray(head.table.valid), "cpu")
    res = TEngine(TConfig(sort_mode="fused", **CFG_CORPUS), device="cpu").run(rows[split:], acc=acc)
    _assert_same_table(res, whole)
    assert res.to_host_pairs() == whole.to_host_pairs()


def test_kernel_table_past_its_slots_flags_and_refolds_exactly(monkeypatch, jax_engines):
    """A 16-slot kernel table and 32 residual rows per tile against tiles
    of about 130 distinct keys: the plain version sets the flag from the
    data, every block takes the stock re-fold, and the table is JAX's
    hasht table bit for bit."""
    monkeypatch.setattr(tfused, "FUSED_TABLE_SLOTS", 16)
    lines = _vocab_lines(17, 128, 400, 6, b"v")
    got = TEngine(TConfig(sort_mode="fused", **CFG_RANDOM), device="cpu").run_lines(lines)
    want = jax_engines(CFG_RANDOM, "hasht").run_lines(lines)
    assert got.fused_kernel == "batch" and got.fused_refolds == 2
    _assert_same_table(got, want)
    assert (got.num_segments, got.overflow_tokens) == (want.num_segments, want.overflow_tokens)
    assert dict(got.to_host_pairs()) == dict(py_wordcount(lines, 6, 8))
