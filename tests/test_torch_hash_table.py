"""PyTorch port, hash-table fold: ``hash_aggregate`` (fresh and
incremental, every combine, both combine spellings), ``place_residual``,
each branch of ``aggregate_exact``'s ladder, ``mxu_scatter_add`` and the
``count`` refusal, held against ``locust_tpu/ops/hash_table.py`` on the
same numpy-seeded batches.  Tables, used counts and unresolved masks are
compared bit for bit (no two distinct keys of a batch share a folded
hash, asserted); the tolerance is exact."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.core.kv import KVBatch as JKV
from locust_tpu.ops import hash_table as jht
from locust_tpu_torch.core import bytes_ops, packing
from locust_tpu_torch.core.kv import KVBatch as TKV
from locust_tpu_torch.engine import finalize_host_pairs
from locust_tpu_torch.ops import hash_table as tht


def _words(seed, n_vocab, n_rows, prefix="w"):
    rng = np.random.default_rng(seed)
    vocab = [f"{prefix}{i}".encode() for i in range(n_vocab)]
    return [vocab[i] for i in rng.integers(0, n_vocab, n_rows)]


def _batches(words, values=None, seed=0):
    """The same batch for both packages: keys from ``words`` (an empty
    word is an invalid row), values given or seeded in [-1000, 1000)."""
    keys = bytes_ops.strings_to_rows(list(words), 32)
    if values is None:
        values = np.random.default_rng(seed).integers(-1000, 1000, len(words))
    values = np.asarray(values, np.int32)
    valid = np.array([bool(w) for w in words])
    j = JKV.from_bytes(jnp.asarray(keys), jnp.asarray(values), jnp.asarray(valid))
    t = TKV.from_bytes(torch.from_numpy(keys), torch.from_numpy(values), torch.from_numpy(valid))
    return j, t


def _assert_table_equal(t, j):
    assert np.array_equal(t.key_lanes.numpy().view(np.uint32), np.asarray(j.key_lanes))
    assert np.array_equal(t.values.numpy(), np.asarray(j.values))
    assert np.array_equal(t.valid.numpy(), np.asarray(j.valid))


def _assert_no_folded_collision(tbatch):
    """The precondition of the bit-for-bit comparisons."""
    keys = torch.unique(tbatch.key_lanes[tbatch.valid], dim=0)
    assert len(torch.unique(packing.primary_hash(keys) >> 1)) == len(keys)


@pytest.mark.parametrize("incremental", [False, True])
@pytest.mark.parametrize("combine,impl", [("sum", "xla"), ("sum", "mxu"), ("min", "xla"), ("max", "xla")])
@pytest.mark.parametrize("out_size,probes", [(1024, 4), (32, 2)])
def test_hash_aggregate_bit_identical(incremental, combine, impl, out_size, probes):
    """Fresh: one batch.  Incremental: a second batch into the first's
    table.  The small tables strand rows (probe exhaustion)."""
    words = _words(1, 60, 500)
    words[::17] = [b""] * len(words[::17])
    jb, tb = _batches(words, seed=2)
    _assert_no_folded_collision(tb)
    jt, ju, jun = jht.hash_aggregate(jb, out_size, combine, probes, scatter_impl=impl)
    tt, tu, tun = tht.hash_aggregate(tb, out_size, combine, probes, scatter_impl=impl)
    if incremental:
        jb2, tb2 = _batches(_words(3, 80, 300), seed=4)
        jt, ju, jun = jht.hash_aggregate(jb2, out_size, combine, probes, table=jt, scatter_impl=impl)
        tt, tu, tun = tht.hash_aggregate(tb2, out_size, combine, probes, table=tt, scatter_impl=impl)
    _assert_table_equal(tt, jt)
    assert int(tu) == int(ju) and tu.dtype == torch.int32
    assert np.array_equal(tun.numpy(), np.asarray(jun))
    assert bool(tun.any()) == (out_size < 60)


def test_lane0_zero_rows_return_as_unresolved():
    lanes = np.zeros((2, 8), np.uint32)
    lanes[1, 1] = 0x61000000
    values, valid = np.array([7, 1], np.int32), np.array([True, True])
    j = JKV(jnp.asarray(lanes), jnp.asarray(values), jnp.asarray(valid))
    t = TKV(torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(values), torch.from_numpy(valid))
    jt, ju, jun = jht.hash_aggregate(j, 16)
    tt, tu, tun = tht.hash_aggregate(t, 16)
    _assert_table_equal(tt, jt)
    assert tun.tolist() == [True, True] and int(tu) == int(ju) == 0


def test_degenerate_hash_exact_and_no_phantom_slots(monkeypatch):
    """Every key hashes alike: all rows fight for one slot per round, and
    distinct keys share a folded hash, so two of them win one empty slot
    together.  The matched-slot guard keeps every resolved key exact and
    no written-but-unmatched slot in the table."""
    real = packing.hash_pair

    def degenerate(lanes):
        h1, h2 = real(lanes)
        return torch.full_like(h1, 123457), torch.full_like(h2, 7)

    monkeypatch.setattr(packing, "hash_pair", degenerate)
    words = [b"w%d" % (i % 25) for i in range(200)]
    _, tb = _batches(words, values=np.ones(200))
    table, used, unresolved = tht.hash_aggregate(tb, 64)
    got = dict(table.to_host_pairs())
    oracle = collections.Counter(words)
    assert len(got) == int(used) <= 4
    assert all(v == oracle[k] for k, v in got.items())
    assert sum(got.values()) + int(unresolved.sum()) == len(words)


def test_place_residual_bit_identical():
    words = [f"key{i}".encode() for i in range(40)] * 5
    jb, tb = _batches(words, seed=5)
    jt, ju, jun = jht.hash_aggregate(jb, 64)
    tt, tu, tun = tht.hash_aggregate(tb, 64)
    assert int(tun.sum()) > 0
    jm, jd = jht.place_residual(jt, ju, jb, jun)
    tm, td = tht.place_residual(tt, tu, tb, tun)
    _assert_table_equal(tm, jm)
    assert int(td) == int(jd) == 40


# (out_size, probes, vocabulary, rows): the ladder branch each one takes.
LADDER = {
    "fast": (4096, 4, 300, 3000),
    "small": (64, 4, 60, 800),
    "full": (64, 1, 3000, 9000),
}


@pytest.mark.parametrize("impl", ["xla", "mxu"])
@pytest.mark.parametrize("branch", list(LADDER))
def test_aggregate_exact_ladder_bit_identical(branch, impl):
    out_size, probes, n_vocab, n_rows = LADDER[branch]
    jb, tb = _batches(_words(7, n_vocab, n_rows, prefix="k"), seed=8)
    _, _, tun = tht.hash_aggregate(tb, out_size, "sum", probes)
    n_unres = int(tun.sum())
    assert {"fast": n_unres == 0, "small": 0 < n_unres <= tht.RESIDUAL_CAP,
            "full": n_unres > tht.RESIDUAL_CAP}[branch]
    jt, jd = jht.aggregate_exact(jb, out_size, "sum", probes, scatter_impl=impl)
    tt, td = tht.aggregate_exact(tb, out_size, "sum", probes, scatter_impl=impl)
    _assert_table_equal(tt, jt)
    assert int(td) == int(jd)
    if branch != "full":
        want = collections.Counter()
        for k, v in tb.to_host_pairs():
            want[k] += v
        assert dict(finalize_host_pairs(tt, "sum")) == {
            k: int(np.int32(v)) for k, v in want.items()}


@pytest.mark.parametrize("chunk", [None, 1000])
def test_mxu_scatter_add_bit_identical(chunk):
    """Sums wrap mod 2^32 like an int32 scatter-add: negative values and
    values near the int32 limits, masked rows and a multi-chunk run."""
    rng = np.random.default_rng(12)
    n, out_size = 5000, 700
    slot = rng.integers(0, out_size, n).astype(np.int32)
    values = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    values[:50] = 2**31 - 1
    values[50:100] = -(2**31)
    mask = rng.random(n) < 0.8
    js, jh = jht.mxu_scatter_add(jnp.asarray(slot), jnp.asarray(values), jnp.asarray(mask),
                                 out_size, chunk=chunk)
    ts, th = tht.mxu_scatter_add(torch.from_numpy(slot), torch.from_numpy(values),
                                 torch.from_numpy(mask), out_size, chunk=chunk)
    assert ts.dtype == torch.int32
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    want = np.zeros(out_size, np.int64)
    np.add.at(want, slot[mask], values[mask])
    assert np.array_equal(ts.numpy(), want.astype(np.int64).astype(np.uint32).view(np.int32))
    with pytest.raises(ValueError, match="chunk"):
        tht.mxu_scatter_add(torch.from_numpy(slot), torch.from_numpy(values),
                            torch.from_numpy(mask), out_size, chunk=0)


def test_count_combine_rejected_not_corrupted():
    _, tb = _batches([b"a", b"b"])
    with pytest.raises(ValueError, match="normalize_combine"):
        tht.aggregate_exact(tb, 16, combine="count")
    with pytest.raises(ValueError, match="combine must be one of"):
        tht.hash_aggregate(tb, 16, combine="count")


@pytest.mark.parametrize("mode", ["hasht", "hasht-mxu", "fused"])
def test_fold_into_hasht_family_equals_jax(mode):
    """The fold dispatch: a hasht-family fold of new rows into a table is
    ``aggregate_exact`` over their concat in both packages."""
    jacc, tacc = _batches(_words(13, 70, 400), seed=14)
    jnew, tnew = _batches(_words(15, 90, 400), seed=16)
    ja, _ = jht.reduce_into(jacc, 256, "sum", mode)
    ta, _ = tht.reduce_into(tacc, 256, "sum", mode)
    _assert_table_equal(ta, ja)
    jt, jd = jht.fold_into(ja, jnew, 256, "sum", mode)
    tt, td = tht.fold_into(ta, tnew, 256, "sum", mode)
    _assert_table_equal(tt, jt)
    assert int(td) == int(jd)
    assert tht.scatter_impl_for(mode) == jht.scatter_impl_for(mode)
