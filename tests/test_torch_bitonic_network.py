"""PyTorch port, kernel B's permutation and launch plan.

``bitonic_network_reference`` (Batcher's network as vectorised torch ops)
is held exactly, keys and payload rows in order, against the JAX Pallas
``bitonic_sort`` in interpret mode with 8-row tiles, so that JAX's
cross-tile passes run too; and against the stable plain version through
per-key multisets.  A numpy simulator runs ``config.bitonic_launch_plan``
launch by launch (each launch's substages on the element groups it
names) and must give the reference's permutation, run every substage
exactly once in the network's order, and launch ``1 + 2*(kbits - m)``
times."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.ops.pallas.sort import bitonic_sort as jbitonic
from locust_tpu_torch.config import (
    BITONIC_MAX_BLOCK_BITS,
    BITONIC_MAX_CROSS_BITS,
    bitonic_launch_plan,
)
from locust_tpu_torch.ops.kernels.sort import (
    bitonic_network_reference,
    bitonic_reference,
    plan_steps,
    padded_size,
    tile_bits,
)

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


def simulate_plan(key_u32, kbits, m):
    """Runs ``bitonic_launch_plan(kbits, m)`` on (key, row) words: per
    launch, the global indices of each block's elements from its
    ``(block_bits, low_bits, cross_at)``, then its substages on those
    groups.  Returns the words and the substages in the order run."""
    n_pad, n = 1 << kbits, len(key_u32)
    keys = np.full(n_pad, 0xFFFFFFFF, np.uint64)
    keys[:n] = key_u32
    words = (keys << np.uint64(32)) | np.arange(n_pad, dtype=np.uint64)
    ran = []
    for block, low, cross_at, stages in bitonic_launch_plan(kbits, m):
        c = block - low
        assert 0 <= c <= BITONIC_MAX_CROSS_BITS and block <= BITONIC_MAX_BLOCK_BITS
        loc = np.arange(1 << block, dtype=np.int64)
        blk = np.arange(1 << (kbits - block), dtype=np.int64)
        lo_bits = cross_at - low
        fixed = ((blk & ((1 << lo_bits) - 1)) << low) | ((blk >> lo_bits) << (cross_at + c))
        g = fixed[:, None] | (loc & ((1 << low) - 1)) | ((loc >> low) << cross_at)
        assert np.array_equal(np.sort(g, axis=None), np.arange(n_pad))  # a partition
        grp = words[g]
        for s, t_hi, t_lo in stages:
            desc = ((g >> s) & 1).astype(bool)
            for t in range(t_hi, t_lo - 1, -1):
                gb = t - 1
                assert gb < low or cross_at <= gb < cross_at + c, "bit outside the block"
                lb = gb if gb < low else low + gb - cross_at
                ran.append((s, t))
                v = grp.reshape(len(blk), -1, 2, 1 << lb)
                lo, hi = v[:, :, 0], v[:, :, 1]
                # The lower element keeps the min in an ascending block:
                # swap where the keys are out of order, never on ties.
                klo, khi = lo >> np.uint64(32), hi >> np.uint64(32)
                swap = np.where(desc.reshape(v.shape)[:, :, 0], klo < khi, khi < klo)
                new_lo = np.where(swap, hi, lo)
                v[:, :, 1] = np.where(swap, lo, hi)
                v[:, :, 0] = new_lo
        words[g] = grp
    return words, ran


def _plan_cases():
    """Every shape with the tile the wrapper picks; the largest tile the
    kernel takes up to 2^18 elements."""
    for kbits in range(10, 21):
        yield kbits, tile_bits(kbits)
        if tile_bits(kbits) < BITONIC_MAX_BLOCK_BITS <= kbits <= 18:
            yield kbits, BITONIC_MAX_BLOCK_BITS


@functools.lru_cache(maxsize=None)
def _plan_case(kbits):
    """Keys with a few pad rows, and the network reference's result."""
    n = (1 << kbits) - 3 * kbits
    keys = _keys("dups" if kbits % 2 else "random", n, kbits)
    return n, keys, bitonic_network_reference(*_torch(keys, np.arange(n, dtype=np.int32)[:, None]))


@pytest.mark.parametrize("kbits,m", list(_plan_cases()))
def test_launch_plan_simulated_equals_network_reference(kbits, m):
    n, keys, (rk, rr) = _plan_case(kbits)
    words, ran = simulate_plan(keys, kbits, m)
    assert ran == [(s, t) for s in range(1, kbits + 1) for t in range(s, 0, -1)]
    assert len(bitonic_launch_plan(kbits, m)) == 1 + 2 * (kbits - m)
    assert np.array_equal((words[:n] >> np.uint64(32)).astype(np.uint32), rk.numpy().view(np.uint32))
    src = (words[:n] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    assert np.array_equal(np.where(src < n, src, 0), rr.numpy()[:, 0])


def test_launch_plan_shapes():
    # The main path's shapes: 147,456 and 81,920 rows, 2^11 tiles.
    assert padded_size(147_456) == 1 << 18 and plan_steps(147_456) == 15
    assert padded_size(81_920) == 1 << 17 and plan_steps(81_920) == 13
    assert plan_steps(1) == 1 and plan_steps(2049) == 3
    # Tile launches first and last; each cross launch reads runs of at
    # least 2^3 consecutive elements.
    plan = bitonic_launch_plan(20, 11)
    assert plan[0][:3] == plan[-1][:3] == (11, 11, 11)
    assert all(low >= 3 for block, low, _, _ in plan)
    # Beyond BITONIC_MAX_CROSS_BITS, a stage's cross substages split.
    assert len(bitonic_launch_plan(22, 11)) > 1 + 2 * 11
    with pytest.raises(ValueError):
        bitonic_launch_plan(10, 11)
