"""PyTorch port, hash-table fold, continued from
tests/test_torch_hash_table.py: each branch of ``aggregate_exact``'s
ladder, ``mxu_scatter_add``, the ``count`` refusal and the hasht-family
``fold_into``, held against ``locust_tpu/ops/hash_table.py`` bit for bit
on the same numpy-seeded batches."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.ops import hash_table as jht
from locust_tpu_torch.engine import finalize_host_pairs
from locust_tpu_torch.ops import hash_table as tht
from test_torch_hash_table import _assert_table_equal, _batches, _words


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
