"""PyTorch port, ``sort_mode="fused"`` and the hasht family end to end.

The primitive: the plain version of the fused kernel,
``fused_preagg_reference`` (what ``fused_block_preagg`` runs on a CPU
tensor), against the JAX ``fused_block_preagg(interpret=True)`` on the
same numpy-seeded blocks: the union of table and residual rows (duplicate
keys re-merged), the overflow and the flag are equal, and equal the
Python oracle.  The kernels' internal layouts may differ; their union may
not.  Then shape validation, the eligibility gates and their reasons, and
``count`` engaging the kernel.

The engine: the port's ``fused``, ``hasht`` and ``hasht-mxu`` tables are
bit-identical to the JAX ``fused`` and ``hasht`` tables, with equal
``num_segments``, ``overflow_tokens``, ``truncated``, ``fused_kernel`` and
``fused_demoted``, over the sample corpus and seeded random corpora,
including a settlement that leaves its fast path and a truncation; and a
fold continued from a JAX ``hasht`` table gives JAX's own table.  Exact
throughout; bit-identity holds because no two distinct keys of these
corpora share a folded hash (asserted).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import py_wordcount
from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.engine import MapReduceEngine as JEngine
from locust_tpu.engine import finalize_host_pairs as jfinalize
from locust_tpu.core.kv import KVBatch as JKV
from locust_tpu.ops.map_stage import wordcount_map as jwordcount_map
from locust_tpu.ops.pallas import fused_fold as jfused
from locust_tpu_torch.config import FUSED_TABLE_SLOTS
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.core import bytes_ops, packing
from locust_tpu_torch.core.kv import KVBatch as TKV
from locust_tpu_torch.engine import MapReduceEngine as TEngine
from locust_tpu_torch.engine import finalize_host_pairs as tfinalize
from locust_tpu_torch.io.loader import load_lines
from locust_tpu_torch.ops.kernels import fused_fold as tfused
from locust_tpu_torch.ops.map_stage import wordcount_map as twordcount_map
from locust_tpu_torch.state import table_from_jax, table_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "sample_corpus.txt")


def _vocab_lines(seed, n_lines, n_vocab, per_line, prefix=b"k"):
    rng = np.random.default_rng(seed)
    vocab = [prefix + b"%03d" % i for i in range(n_vocab)]
    return [b" ".join(vocab[j] for j in rng.integers(0, n_vocab, per_line))
            for _ in range(n_lines)]


# ---------------------------------------------------------- the primitive


def _preagg_both(lines, cfg_kw, **kw):
    """Run the JAX kernel (interpret mode) and the port's plain version on
    the same block; returns ``(jax, port)`` as (pairs, overflow, flag)."""
    rows = bytes_ops.strings_to_rows(lines, cfg_kw["line_width"])
    jt, jr, jo, jf = jfused.fused_block_preagg(
        jnp.asarray(rows), JConfig(**cfg_kw), interpret=True, **kw
    )
    tt, tr, to, tf = tfused.fused_block_preagg(torch.from_numpy(rows), TConfig(**cfg_kw), **kw)
    assert tt.size == kw.get("table_slots", FUSED_TABLE_SLOTS) and tr.size == jr.size
    assert to.dtype == torch.int32 and tf.dtype == torch.bool
    j = (dict(jfinalize(JKV.concat(jt, jr), "sum")), int(jo), bool(jf))
    t = (dict(tfinalize(TKV.concat(tt, tr), "sum")), int(to), bool(tf))
    return j, t, (tt, tr)


@pytest.mark.parametrize("n_tiles", [1, 3, 4])
def test_preagg_union_equals_jax_and_oracle(n_tiles):
    cfg_kw = dict(block_lines=32 * n_tiles, line_width=128, key_width=8,
                  emits_per_line=6, sort_mode="fused")
    rng = np.random.default_rng(n_tiles)
    vocab = [b"w%02d" % i for i in range(40)] + [b"longer-token", b"x"]
    lines = [b" ".join(vocab[j] for j in rng.integers(0, len(vocab), 7))
             for _ in range(cfg_kw["block_lines"])]
    j, t, _ = _preagg_both(lines, cfg_kw, table_slots=1024, resid_rows=32)
    assert t == j
    assert t[0] == py_wordcount(lines, 6, 8) and t[1] > 0 and not t[2]


def test_preagg_table_tile_wraparound():
    """table_slots=512, below the JAX kernel's padded 8 x 512 layout: the
    port's table has exactly its 512 slots, and its union with the
    residual is JAX's."""
    cfg_kw = dict(block_lines=32, line_width=128, key_width=8,
                  emits_per_line=6, sort_mode="fused")
    lines = [b"aa bb cc dd ee", b"aa bb cc", b"ff gg"] * 10 + [b""] * 2
    j, t, (tab, _) = _preagg_both(lines, cfg_kw, table_slots=512, resid_rows=32)
    assert tab.size == 512 and int(tab.valid.sum()) == 7
    assert t == j and t[0] == py_wordcount(lines, 6, 8)


def test_preagg_residual_carries_stranded_keys_exactly():
    cfg_kw = dict(block_lines=64, line_width=128, key_width=8,
                  emits_per_line=8, sort_mode="fused")
    lines = _vocab_lines(7, 64, 150, 6)
    j, t, (_, resid) = _preagg_both(lines, cfg_kw, table_slots=64, resid_rows=256)
    assert int(resid.valid.sum()) > 0 and not t[2]
    assert t == j and t[0] == py_wordcount(lines, 8, 8)


def test_preagg_residual_overflow_flag_is_set():
    """More distinct keys in a tile than table slots plus residual rows:
    the flag is set whatever the order of insertion."""
    cfg_kw = dict(block_lines=32, line_width=128, key_width=8,
                  emits_per_line=8, sort_mode="fused")
    lines = _vocab_lines(11, 32, 200, 7)
    j, t, _ = _preagg_both(lines, cfg_kw, table_slots=16, resid_rows=8)
    assert t[2] and j[2] and t[1] == j[1]


def test_preagg_shape_validation():
    cfg = TConfig(sort_mode="fused")
    with pytest.raises(ValueError, match="multiple of 32"):
        tfused.fused_block_preagg(torch.zeros((48, 128), dtype=torch.uint8), cfg)
    with pytest.raises(ValueError, match="multiple of 128"):
        tfused.fused_block_preagg(torch.zeros((32, 64), dtype=torch.uint8), cfg)
    with pytest.raises(ValueError, match="power of two"):
        tfused.fused_block_preagg(torch.zeros((32, 128), dtype=torch.uint8), cfg,
                                  table_slots=768)
    with pytest.raises(ValueError, match="no kernel"):
        tfused.fused_block_preagg(torch.zeros((32, 128), dtype=torch.uint8, device="meta"), cfg)


def test_engine_eligibility_gates_and_reasons_equal_jax():
    def jother(lines, cfg):
        return jwordcount_map(lines, cfg)

    def tother(lines, cfg):
        return twordcount_map(lines, cfg)

    cases = [
        (dict(block_lines=64), "sum", True),
        (dict(block_lines=64), "count", True),
        (dict(block_lines=48), "sum", True),
        (dict(block_lines=64, line_width=192), "sum", True),
        (dict(block_lines=64), "min", True),
        (dict(block_lines=64), "sum", False),
        (dict(block_lines=8192, emits_per_line=2048), "sum", True),
    ]
    for kw, combine, wordcount in cases:
        cfg = dict(kw, sort_mode="fused")
        j = jfused.fused_engine_eligible(
            JConfig(**cfg), jwordcount_map if wordcount else jother, combine)
        t = tfused.fused_engine_eligible(
            TConfig(**cfg), twordcount_map if wordcount else tother, combine)
        assert t[0] == j[0], (kw, combine, wordcount)
        if "line_width" in kw or "emits_per_line" in kw:
            # JAX's own gates, whose reasons name them as parity, not as
            # a limit of the CUDA kernel.
            assert t[1].split()[0] == j[1].split()[0]
            assert "kept for parity" in t[1] and t[1].endswith("folding exactly like 'hasht'")
        else:
            assert t == j, (kw, combine, wordcount)
    assert [tfused.fused_engine_eligible(TConfig(**dict(kw, sort_mode="fused")),
                                         twordcount_map, c)[0]
            for kw, c, w in cases if w] == [True, True, False, False, False, False]


def test_ineligible_engine_is_demoted_and_exact():
    eng = TEngine(TConfig(block_lines=48, line_width=64, sort_mode="fused"), device="cpu")
    res = eng.run_lines([b"a b a", b"c"])
    assert dict(res.to_host_pairs()) == {b"a": 2, b"b": 1, b"c": 1}
    assert res.fused_kernel is None and res.fused_demoted and res.fused_refolds == 0


def test_count_combine_engages_kernel():
    cfg = TConfig(block_lines=32, line_width=128, key_width=8,
                  emits_per_line=6, sort_mode="fused")
    res = TEngine(cfg, combine="count", device="cpu").run_lines([b"a b a", b"b b"] * 4)
    assert dict(res.to_host_pairs()) == {b"a": 8, b"b": 12}
    assert res.fused_kernel == "batch" and not res.fused_demoted


def test_flagged_block_refolds_through_the_stock_path(monkeypatch):
    """A set flag discards the kernel's rows and folds the block's emits:
    the table stays the hasht table, and the re-fold is counted."""
    lines = load_lines(CORPUS)[:200]
    cfg_kw = dict(block_lines=64, key_width=8, emits_per_line=6, table_size=4096)
    want = TEngine(TConfig(sort_mode="hasht", **cfg_kw), device="cpu").run_lines(lines)
    real = tfused.fused_preagg_reference

    def flagged(*args, **kw):
        tab, resid, ovf, _ = real(*args, **kw)
        return tab, resid, ovf, torch.tensor(True)

    monkeypatch.setattr(tfused, "fused_preagg_reference", flagged)
    got = TEngine(TConfig(sort_mode="fused", **cfg_kw), device="cpu").run_lines(lines)
    assert got.fused_refolds == 4
    assert torch.equal(got.table.key_lanes, want.table.key_lanes)
    assert torch.equal(got.table.values, want.table.values)
    assert got.overflow_tokens == want.overflow_tokens


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


# ------------------------------------------------- the engine against JAX

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
