"""PyTorch port, the torch.sort modes ``lex``, ``hash``, ``hashp``,
``hashp2``, ``hash1`` and ``radix`` against the JAX package.

* ``radix_argsort``: the permutation equals JAX's element for element
  (both are stable LSD counting sorts), over digit widths, chunks, key
  bits and sentinel keys, and it refuses what JAX refuses.
* ``sort_and_compact``: JAX's multi-key ``lax.sort`` need not be stable,
  so a sorted batch is compared as its valid prefix, the sequence of key
  runs and each run's multiset of values; radix (stable in both) is
  compared row for row.
* The engine's fold: ``num_segments``, overflow, tables bit for bit and
  host pairs equal JAX's for combine sum, count, min and max (min/max
  over a map whose values vary by emit position).  The JAX engine runs
  op by op (``jax.disable_jit``) to keep this file quick.

Bit-identity of tables holds because no two distinct keys of these
corpora share a folded sort key (asserted).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.core.kv import KVBatch as JKV
from locust_tpu.engine import MapReduceEngine as JEngine
from locust_tpu.ops.map_stage import wordcount_map as jwordcount_map
from locust_tpu.ops.process_stage import sort_and_compact as jsort
from locust_tpu.ops.radix_sort import radix_argsort as jradix
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.core.kv import KVBatch as TKV
from locust_tpu_torch.engine import MapReduceEngine as TEngine
from locust_tpu_torch.io.loader import load_rows
from locust_tpu_torch.ops.map_stage import wordcount_map as twordcount_map
from locust_tpu_torch.ops.process_stage import _folded_key
from locust_tpu_torch.ops.process_stage import sort_and_compact as tsort
from locust_tpu_torch.ops.radix_sort import radix_argsort as tradix
from locust_tpu_torch.state import table_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "sample_corpus.txt")
NEW_MODES = ("lex", "hash", "hashp", "hashp2", "hash1", "radix")
CFG = dict(block_lines=64, line_width=128, emits_per_line=8, key_width=16, table_size=2048)


# ------------------------------------------------------------ radix_argsort


@pytest.mark.parametrize("n,bits,chunk,key_bits", [
    (5000, 8, 8192, 32), (3000, 4, 1024, 32), (1500, 11, 512, 32),
    (1000, 8, 256, 16), (777, 4, 4096, 16), (1, 8, 8192, 32),
])
def test_radix_argsort_equals_jax(n, bits, chunk, key_bits):
    rng = np.random.default_rng(n + bits)
    pool = rng.integers(0, 2**32, max(n // 5, 1), dtype=np.uint64).astype(np.uint32)
    pool[::4] = 0xFFFFFFFF  # real keys equal to the pad sentinel
    keys = pool[rng.integers(0, len(pool), n)]
    want = np.asarray(jradix(jnp.asarray(keys), bits=bits, chunk=chunk, key_bits=key_bits))
    got = tradix(torch.from_numpy(keys.view(np.int32)), bits=bits, chunk=chunk,
                 key_bits=key_bits).numpy()
    assert np.array_equal(got, want)
    low = keys & np.uint32((1 << key_bits) - 1)
    assert np.all(np.diff(low[got].astype(np.int64)) >= 0)


def test_radix_argsort_refuses_what_jax_refuses():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tradix(k.to(torch.int64))
    with pytest.raises(TypeError):
        jradix(jnp.zeros(8, jnp.int32))
    for kw in ({"bits": 17}, {"chunk": 65536}):
        with pytest.raises(ValueError, match="overflow uint16"):
            tradix(k, **kw)
        with pytest.raises(ValueError, match="overflow uint16"):
            jradix(jnp.zeros(8, jnp.uint32), **kw)


# --------------------------------------------------------- sort_and_compact


@pytest.fixture(scope="module")
def batch_np():
    """700 rows of 4-lane keys from a 60-key vocabulary (some keys with
    zero tails), signed values, 15% invalid rows."""
    rng = np.random.default_rng(7)
    vocab = rng.integers(0, 2**32, (60, 4), dtype=np.uint64).astype(np.uint32)
    vocab[::5, 2:] = 0
    lanes = vocab[rng.integers(0, 60, 700)]
    values = rng.integers(-1000, 1000, 700).astype(np.int32)
    valid = rng.random(700) > 0.15
    folded = _folded_key(TKV(torch.from_numpy(vocab.view(np.int32)),
                             torch.zeros(60, dtype=torch.int32), torch.ones(60, dtype=torch.bool)))
    assert len(torch.unique(folded)) == 60  # no folded-key collision
    return lanes, values, valid


def _runs(lanes, values, valid):
    """The valid prefix as [(key, sorted values)] runs of equal keys."""
    nv = int(valid.sum())
    assert valid[:nv].all() and not valid[nv:].any()
    runs = []
    for key, v in zip(map(tuple, lanes[:nv]), values[:nv]):
        if runs and runs[-1][0] == key:
            runs[-1][1].append(int(v))
        else:
            runs.append((key, [int(v)]))
    return [(k, sorted(v)) for k, v in runs]


@pytest.mark.parametrize("mode", NEW_MODES)
def test_sort_and_compact_equals_jax(mode, batch_np):
    lanes, values, valid = batch_np
    j = jsort(JKV(jnp.asarray(lanes), jnp.asarray(values), jnp.asarray(valid)), mode)
    t = tsort(TKV(torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(values),
                  torch.from_numpy(valid)), mode)
    jl, jv, jok = (np.asarray(x) for x in (j.key_lanes, j.values, j.valid))
    tl, tv, tok = table_to_numpy(t)
    assert _runs(tl, tv, tok) == _runs(jl, jv, jok)
    keys = [k for k, _ in _runs(tl, tv, tok)]
    assert len(set(keys)) == len(keys)  # every key in one run
    if mode == "lex":
        assert keys == sorted(keys)
    if mode == "radix":  # stable in both packages: the same rows in order
        assert np.array_equal(tl, jl) and np.array_equal(tv, jv) and np.array_equal(tok, jok)


# --------------------------------------------------------------- the fold


def jposition_map(lines, cfg):
    kv, overflow = jwordcount_map(lines, cfg)
    pos = jnp.arange(kv.values.shape[0], dtype=jnp.int32)
    return JKV(kv.key_lanes, pos % 97 - 40, kv.valid), overflow


def tposition_map(lines, cfg):
    kv, overflow = twordcount_map(lines, cfg)
    pos = torch.arange(kv.values.shape[0], dtype=torch.int32)
    return TKV(kv.key_lanes, pos % 97 - 40, kv.valid), overflow


@pytest.fixture(scope="module")
def rows():
    return load_rows(CORPUS, 128)[:320]  # 5 blocks


@pytest.mark.parametrize("combine", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("mode", NEW_MODES)
def test_fold_equals_jax(mode, combine, rows):
    jmap, tmap = ((jwordcount_map, twordcount_map) if combine in ("sum", "count")
                  else (jposition_map, tposition_map))
    jeng = JEngine(JConfig(**CFG, sort_mode=mode), map_fn=jmap, combine=combine)
    with jax.disable_jit():
        j = jeng.run(rows)
    t = TEngine(TConfig(**CFG, sort_mode=mode, use_pallas=True), map_fn=tmap,
                combine=combine, device="cpu").run(rows)
    assert t.num_segments == j.num_segments > 300
    assert t.overflow_tokens == j.overflow_tokens > 0
    assert t.truncated == j.truncated is False
    lanes, values, valid = table_to_numpy(t.table)
    assert np.array_equal(lanes, np.asarray(j.table.key_lanes))
    assert np.array_equal(values, np.asarray(j.table.values))
    assert np.array_equal(valid, np.asarray(j.table.valid))
    assert t.to_host_pairs() == j.to_host_pairs()
    folded = _folded_key(t.table)[t.table.valid]
    assert len(torch.unique(folded)) == t.num_segments  # the precondition


@pytest.mark.parametrize("mode", NEW_MODES)
def test_timed_run_in_every_new_mode(mode, rows):
    eng = TEngine(TConfig(**CFG, sort_mode=mode, use_pallas=True), device="cpu")
    assert eng.timed_run(rows).to_host_pairs() == eng.run(rows).to_host_pairs()
