"""PyTorch port, kernel B's permutation and launch plan.

``bitonic_network_reference`` (Batcher's network as vectorised torch ops)
is held exactly, keys and payload rows in order, against the JAX Pallas
``bitonic_sort`` in interpret mode with 8-row tiles, so that JAX's
cross-tile passes run too; and against the stable plain version through
per-key multisets.  The launch plan's simulator is in
tests/test_torch_bitonic_plan.py."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.ops.pallas.sort import bitonic_sort as jbitonic
from locust_tpu_torch.ops.kernels.sort import bitonic_network_reference, bitonic_reference

N_PAYLOADS = 3


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 2**32 - 1, n, dtype=np.uint32)
    if kind == "equal":
        return np.full(n, 0x9E3779B9, np.uint32)
    if kind == "sentinel":  # real keys equal to the pad's 0xFFFFFFFF
        return rng.choice(np.array([3, 0x80000000, 0xFFFFFFFF], np.uint32), n)
    # duplicate-heavy, the high bit set on some keys (unsigned order matters)
    return rng.choice(np.array([0, 5, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE], np.uint32), n)


def _rows(n, seed, width=N_PAYLOADS):
    rng = np.random.default_rng(seed + 1)
    rows = rng.integers(-(2**31), 2**31, (n, width), dtype=np.int64).astype(np.int32)
    if width:
        rows[:, 0] = np.arange(n, dtype=np.int32)
    return rows


def _torch(keys, rows):
    return torch.from_numpy(keys.view(np.int32).copy()), torch.from_numpy(rows)


@functools.partial(jax.jit, static_argnames=("tile_rows",))
def _jax_bitonic(key, payloads, tile_rows):
    return jbitonic(key, payloads, tile_rows=tile_rows, interpret=True)


JAX_CASES = [(n, kind) for n in (1, 7, 1000, 1024, 5000, 8192)
             for kind in ("random", "equal", "dups")] + [(7, "sentinel"), (5000, "sentinel")]


@pytest.mark.parametrize("n,kind", JAX_CASES)
def test_network_reference_equals_jax_kernel_in_order(n, kind):
    keys, rows = _keys(kind, n, n), _rows(n, n)
    jk, jp = _jax_bitonic(jnp.asarray(keys), tuple(jnp.asarray(c) for c in rows.T), tile_rows=8)
    jrows = np.stack([np.asarray(p) for p in jp], 1)
    tk, tr = bitonic_network_reference(*_torch(keys, rows))
    assert np.array_equal(tk.numpy().view(np.uint32), np.asarray(jk))
    assert np.array_equal(tr.numpy(), jrows)
    if kind == "sentinel":  # a pad row took a real row's place: zero payload
        assert (tr.numpy()[:, 0] == 0).sum() >= 1


def _multiset(key_u32, rows):
    table = np.concatenate([key_u32[:, None].astype(np.int64), rows.astype(np.int64)], 1)
    return table[np.lexsort(table.T[::-1])]


@pytest.mark.parametrize("kind", ["random", "equal", "dups"])
@pytest.mark.parametrize("n,width", [(1, 3), (1000, 3), (2049, 0), (5000, 9)])
def test_network_reference_equals_stable_sort_as_multisets(n, width, kind):
    keys, rows = _keys(kind, n, n + 7), _rows(n, n + 7, width)
    tk, tr = bitonic_network_reference(*_torch(keys, rows))
    sk, sr = bitonic_reference(*_torch(keys, rows))
    assert torch.equal(tk, sk)
    assert tr.shape == (n, width)
    assert np.array_equal(_multiset(tk.numpy().view(np.uint32), tr.numpy()),
                          _multiset(sk.numpy().view(np.uint32), sr.numpy()))


