"""PyTorch port, Process + Reduce: the bitonic sort's plain version held
against the JAX Pallas bitonic kernel in interpret mode, and
``sort_and_compact`` ("bitonic", "hashp1") + ``segment_reduce_into``
against the JAX package.  Exact equality; sort ties may order payloads
differently (the kernel is not stable), so payload rows are compared as
per-key multisets, and tables where no two distinct keys share a folded
key (asserted)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.core.kv import KVBatch as JKVBatch
from locust_tpu.ops import map_stage as jmap
from locust_tpu.ops import process_stage as jprocess
from locust_tpu.ops import reduce_stage as jreduce
from locust_tpu.ops.pallas.sort import bitonic_sort as jbitonic
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.core.kv import KVBatch as TKVBatch
from locust_tpu_torch.ops import process_stage as tprocess
from locust_tpu_torch.ops import reduce_stage as treduce
from locust_tpu_torch.ops.hash_table import fold_into, reduce_into
from locust_tpu_torch.ops.kernels.sort import bitonic_sort_rows, padded_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAYLOADS = 3


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 2**32 - 1, n, dtype=np.uint32)
    if kind == "equal":
        return np.full(n, 0x9E3779B9, np.uint32)
    # duplicate-heavy, high bit set on some keys (unsigned order matters)
    return rng.choice(np.array([0, 5, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE], np.uint32), n)


def _payloads(n, seed):
    rng = np.random.default_rng(seed + 1)
    pay = rng.integers(-(2**31), 2**31, (N_PAYLOADS, n), dtype=np.int64).astype(np.int32)
    pay[0] = np.arange(n, dtype=np.int32)
    return pay


def _canonical(key_u32, pay):
    """(key, payload rows) sorted lexicographically: a per-key multiset."""
    rows = np.concatenate([key_u32[:, None].astype(np.int64), pay.T.astype(np.int64)], 1)
    return rows[np.lexsort(rows.T[::-1])]


_jit_bitonic = jax.jit(lambda k, p: jbitonic(k, p, interpret=True))

CASES = [(1, "random"), (1000, "random"), (1000, "equal"), (1500, "dups"), (1500, "random")]


@pytest.mark.parametrize("n,kind", CASES)
def test_bitonic_plain_equals_jax_kernel(n, kind):
    keys, pay = _keys(kind, n, n), _payloads(n, n)
    jk, jp = _jit_bitonic(jnp.asarray(keys), tuple(jnp.asarray(p) for p in pay))
    jk, jp = np.asarray(jk), np.stack([np.asarray(p) for p in jp])
    tk, tp = bitonic_sort_rows(
        torch.from_numpy(keys.view(np.int32).copy()),
        torch.from_numpy(np.ascontiguousarray(pay.T)),
    )
    tk = tk.numpy().view(np.uint32)
    tp = tp.numpy().T
    assert np.array_equal(tk, np.sort(keys))
    assert np.array_equal(tk, jk)
    assert np.array_equal(_canonical(tk, tp), _canonical(jk, jp))
    assert np.array_equal(_canonical(tk, tp), _canonical(keys, pay))


def test_bitonic_rows_plain_is_stable_and_pads_like_jax():
    keys = torch.tensor([3, -1, 3, 0, -1, 3], dtype=torch.int32)  # -1 = 0xFFFFFFFF
    rows = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    k, r = bitonic_sort_rows(keys, rows)
    assert k.tolist() == [0, 3, 3, 3, -1, -1]
    assert r[:, 0].tolist() == [6, 0, 4, 10, 2, 8]
    assert [padded_size(n) for n in (0, 1, 1024, 1025, 147456)] == [1024, 1024, 1024, 2048, 262144]
    with pytest.raises(TypeError):
        bitonic_sort_rows(keys.to(torch.int64), rows)


# ------------------------------------------------------ process + reduce

CFG = dict(block_lines=64, line_width=128, emits_per_line=8, key_width=16)


def _emit_batch():
    """Three corpus blocks' emits with random counts as values: 1536 rows
    (pads to 2048), duplicate keys, invalid rows."""
    from locust_tpu_torch.io.loader import load_rows

    rows = load_rows(os.path.join(REPO, "data", "sample_corpus.txt"), 128)
    jcfg = JConfig(**CFG)
    kv1, _ = jmap.wordcount_map(jnp.asarray(rows[:64]), jcfg)
    kv2, _ = jmap.wordcount_map(jnp.asarray(rows[300:364]), jcfg)
    kv3, _ = jmap.wordcount_map(jnp.asarray(rows[600:664]), jcfg)
    lanes = np.concatenate([np.asarray(k.key_lanes) for k in (kv1, kv2, kv3)])
    valid = np.concatenate([np.asarray(k.valid) for k in (kv1, kv2, kv3)])
    values = np.random.default_rng(0).integers(1, 50, len(valid)).astype(np.int32)
    return lanes, values, valid


def _tables_equal(t: TKVBatch, j: JKVBatch):
    assert np.array_equal(t.key_lanes.numpy().view(np.uint32), np.asarray(j.key_lanes))
    assert np.array_equal(t.values.numpy(), np.asarray(j.values))
    assert np.array_equal(t.valid.numpy(), np.asarray(j.valid))


@pytest.fixture(scope="module")
def batches():
    lanes, values, valid = _emit_batch()
    j = JKVBatch(jnp.asarray(lanes), jnp.asarray(values), jnp.asarray(valid))
    t = TKVBatch(
        torch.from_numpy(lanes.view(np.int32).copy()),
        torch.from_numpy(values), torch.from_numpy(valid),
    )
    # Precondition for bit-identical tables: distinct keys have distinct
    # folded keys, so ties only ever join rows of one key.
    folded = tprocess._folded_key(t).numpy()
    live = np.unique(lanes[valid], axis=0, return_index=True)[1]
    assert len(np.unique(folded[valid][live])) == len(live)
    jsorted = {m: jprocess.sort_and_compact(j, m) for m in ("bitonic", "hashp1")}
    return j, t, jsorted


@pytest.mark.parametrize("mode", ["bitonic", "hashp1"])
@pytest.mark.parametrize("out_size,combine", [(2048, "sum"), (300, "sum"), (2048, "min"), (2048, "count")])
def test_sort_and_reduce_equal_jax(batches, mode, out_size, combine):
    j, t, jsorted = batches
    ts = tprocess.sort_and_compact(t, mode)
    assert np.array_equal(ts.valid.numpy(), np.asarray(jsorted[mode].valid))
    jt, jn = jreduce.segment_reduce_into(jsorted[mode], out_size, combine)
    tt, tn = treduce.segment_reduce_into(ts, out_size, combine)
    assert tn.dtype == torch.int32 and int(tn) == int(jn)
    _tables_equal(tt, jt)
    if out_size == 300:
        assert int(tn) > out_size  # the truncation case really truncates
    tr, trn = reduce_into(t, out_size, combine, mode)
    _tables_equal(tr, jt)
    assert int(trn) == int(jn)


def test_hashp1_sorted_batch_is_bit_identical(batches):
    j, t, jsorted = batches
    ts = tprocess.sort_and_compact(t, "hashp1")
    js = jsorted["hashp1"]
    _tables_equal(ts, js)


def test_segment_reduce_and_fold_into_equal_jax(batches):
    j, t, jsorted = batches
    jt = jreduce.segment_reduce(jsorted["hashp1"], "max")
    tt = treduce.segment_reduce(tprocess.sort_and_compact(t, "hashp1"), "max")
    _tables_equal(tt, jt)
    acc, _ = reduce_into(t, 1024, "sum", "hashp1")
    merged, n = fold_into(acc, t, 1024, "sum", "hashp1")
    doubled = dict(acc.to_host_pairs())
    assert dict(merged.to_host_pairs()) == {k: 2 * v for k, v in doubled.items()}
    assert int(n) == len(doubled)


def test_sum_wraps_in_int32():
    lanes = torch.zeros((3, 2), dtype=torch.int32)
    values = torch.tensor([2**31 - 1, 5, 7], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    table, n = treduce.segment_reduce_into(TKVBatch(lanes, values, valid), 2)
    jtable, jn = jreduce.segment_reduce_into(
        JKVBatch(jnp.zeros((3, 2), jnp.uint32), jnp.asarray(values.numpy()), jnp.asarray(valid.numpy())), 2
    )
    assert table.values.tolist() == np.asarray(jtable.values).tolist() == [-(2**31) + 4, 0]
    assert int(n) == int(jn) == 1


def test_normalize_combine_count():
    def m(lines, cfg):
        return TKVBatch(torch.zeros((2, 1), dtype=torch.int32), torch.tensor([5, 6], dtype=torch.int32),
                        torch.ones(2, dtype=torch.bool)), torch.tensor(0)

    fn, comb = treduce.normalize_combine(m, "count")
    assert comb == "sum" and fn(None, TConfig())[0].values.tolist() == [1, 1]
    assert treduce.normalize_combine(m, "max") == (m, "max")
