"""PyTorch port, ``sort_mode="fused"`` and the hasht family end to end.

The primitive: the plain version of the fused kernel,
``fused_preagg_reference`` (what ``fused_block_preagg`` runs on a CPU
tensor), against the JAX ``fused_block_preagg(interpret=True)`` on the
same numpy-seeded blocks: the union of table and residual rows (duplicate
keys re-merged), the overflow and the flag are equal, and equal the
Python oracle.  The kernels' internal layouts may differ; their union may
not.  Then shape validation, the eligibility gates and their reasons, and
``count`` engaging the kernel.

The engine's tables against JAX's are in tests/test_torch_fused_engine.py.
"""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import py_wordcount
from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.engine import finalize_host_pairs as jfinalize
from locust_tpu.core.kv import KVBatch as JKV
from locust_tpu.ops.map_stage import wordcount_map as jwordcount_map
from locust_tpu.ops.pallas import fused_fold as jfused
from locust_tpu_torch.config import FUSED_TABLE_SLOTS
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.core.kv import KVBatch as TKV
from locust_tpu_torch.engine import MapReduceEngine as TEngine
from locust_tpu_torch.engine import finalize_host_pairs as tfinalize
from locust_tpu_torch.io.loader import load_lines
from locust_tpu_torch.ops.kernels import fused_fold as tfused
from locust_tpu_torch.ops.map_stage import wordcount_map as twordcount_map

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
