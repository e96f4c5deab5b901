"""PyTorch port, the apps (``locust_tpu_torch.apps``) against the JAX
package on the CPU: ``term_doc_counts``, ``build_tfidf``,
``term_doc_counts_stream`` and ``build_inverted_index`` under
``bitonic``, ``hasht``, ``lex`` and ``hash1``, with 9-lane word keys (a
10-lane tf key); their loss errors; and the 9- and 10-lane hashes and the
index's pair sort.  The port's configurations map through the tokenizer
kernel's wrapper (``use_pallas=True``, its plain version here), the JAX
package's through its plain tokenizer, as each package's apps run."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.apps import inverted_index as jindex
from locust_tpu.apps import tfidf as jtfidf
from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.core import packing as jpacking
from locust_tpu.core.kv import KVBatch as JKV
from locust_tpu.ops import process_stage as jprocess
from locust_tpu_torch.apps import inverted_index as tindex
from locust_tpu_torch.apps import tfidf as ttfidf
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.core import packing as tpacking
from locust_tpu_torch.core.kv import KVBatch as TKV
from locust_tpu_torch.ops import process_stage as tprocess

MODES = ("bitonic", "hasht", "lex", "hash1")
KW = dict(block_lines=64, line_width=128, key_width=36, emits_per_line=8)


def _corpus(n_lines: int = 200, seed: int = 6):
    """Seeded lines of 1-10 words from a 300-word vocabulary, some words
    longer than the 36-byte key, some lines past the 8-emit cap."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    vocab = [letters[rng.integers(0, 26, k)].tobytes() for k in rng.integers(2, 44, 300)]
    return [b" ".join(vocab[j] for j in rng.integers(0, 300, rng.integers(1, 11)))
            for _ in range(n_lines)]


LINES = _corpus()
# Doc ids with zero low bytes (multiples of 1024, 65536 among them): the
# host decode's NUL trap.
DOCS = np.array([(i // 3) * 1024 for i in range(len(LINES))], np.int32)
_jax = {}


def _jax_once(key, fn):
    if key not in _jax:
        _jax[key] = fn()
    return _jax[key]


def _jax_tf(mode):
    """The JAX tf table (lines past the 8-emit cap drop their tail)."""
    return _jax_once(("tf", mode), lambda: jtfidf.term_doc_counts(
        LINES, DOCS, JConfig(sort_mode=mode, **KW), allow_overflow=True))


@pytest.mark.parametrize("mode", MODES)
def test_term_doc_counts_and_tfidf_equal_jax(mode):
    tcfg = TConfig(sort_mode=mode, use_pallas=True, **KW)
    want = _jax_tf(mode)
    got = ttfidf.term_doc_counts(LINES, DOCS, tcfg, allow_overflow=True, device="cpu")
    assert got == want and len(got) > 500
    assert max(len(w) for w, _ in got) == 36 and any(d == 65536 for _, d in got)
    n_docs = len(set(DOCS.tolist()))
    assert ttfidf.build_tfidf(LINES, DOCS, tcfg, allow_overflow=True, device="cpu") == \
        jtfidf.scores_from_tf(want, n_docs) == ttfidf.scores_from_tf(got, n_docs)


@pytest.mark.parametrize("mode", MODES)
def test_term_doc_counts_stream_equals_jax(mode):
    """Chunks of 64, 17 and 40 lines: each padded to a block."""
    jcfg, tcfg = JConfig(sort_mode=mode, **KW), TConfig(sort_mode=mode, use_pallas=True, **KW)
    rows = ttfidf.bytes_ops.strings_to_rows(LINES, KW["line_width"])
    cuts = [0, 64, 81, 121, 185, 200]

    def chunks():
        return ((rows[a:b], DOCS[a:b]) for a, b in zip(cuts, cuts[1:]))

    want = jtfidf.term_doc_counts_stream(chunks(), jcfg, allow_overflow=True)
    got = ttfidf.term_doc_counts_stream(chunks(), tcfg, allow_overflow=True, device="cpu")
    assert got == want == _jax_tf(mode)


@pytest.mark.parametrize("mode", MODES)
def test_build_inverted_index_equals_jax(mode):
    jcfg, tcfg = JConfig(sort_mode=mode, **KW), TConfig(sort_mode=mode, use_pallas=True, **KW)
    # The index's fold does not read sort_mode: one JAX build serves all.
    want = _jax_once("index", lambda: jindex.build_inverted_index(LINES, DOCS, jcfg))
    got = tindex.build_inverted_index(LINES, DOCS, tcfg, device="cpu")
    assert got == want and len(got) > 250
    assert all(docs == sorted(set(docs)) for docs in got.values())


def _raised(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_loss_conditions_raise_as_in_jax(caplog):
    jcfg, tcfg = JConfig(**KW), TConfig(use_pallas=True, **KW)
    few = dataclasses.replace(tcfg, emits_per_line=2)
    jfew = dataclasses.replace(jcfg, emits_per_line=2)
    # Tokens past the per-line cap: tf raises unless allowed.
    assert _raised(ttfidf.term_doc_counts, LINES, DOCS, few, device="cpu") == \
        _raised(jtfidf.term_doc_counts, LINES, DOCS, jfew)
    assert ttfidf.term_doc_counts(LINES, DOCS, few, allow_overflow=True, device="cpu") == \
        jtfidf.term_doc_counts(LINES, DOCS, jfew, allow_overflow=True)
    assert "MISSING" in caplog.text
    # Pair capacity: both apps raise.
    assert _raised(ttfidf.term_doc_counts, LINES, DOCS, tcfg, pairs_capacity=64, device="cpu") == \
        _raised(jtfidf.term_doc_counts, LINES, DOCS, jcfg, pairs_capacity=64)
    assert _raised(tindex.build_inverted_index, LINES, DOCS, tcfg, pairs_capacity=64,
                   device="cpu") == \
        _raised(jindex.build_inverted_index, LINES, DOCS, jcfg, pairs_capacity=64)
    # Doc ids must be >= 0 (they ride an unsigned lane); lengths must match.
    neg = DOCS - 1
    assert _raised(ttfidf.term_doc_counts, LINES, neg, tcfg, device="cpu") == \
        _raised(jtfidf.term_doc_counts, LINES, neg, jcfg)
    assert _raised(tindex.build_inverted_index, LINES, DOCS[:5], tcfg, device="cpu") == \
        _raised(jindex.build_inverted_index, LINES, DOCS[:5], jcfg)


def test_index_drops_past_the_cap_with_a_warning_as_in_jax(caplog):
    jcfg = JConfig(**dict(KW, emits_per_line=2))
    tcfg = TConfig(use_pallas=True, **dict(KW, emits_per_line=2))
    got = tindex.build_inverted_index(LINES, DOCS, tcfg, device="cpu")
    assert got == jindex.build_inverted_index(LINES, DOCS, jcfg)
    assert "postings are MISSING" in caplog.text


@pytest.mark.parametrize("n_lanes", [9, 10])
def test_hashes_of_nine_and_ten_lanes_equal_jax(n_lanes):
    rng = np.random.default_rng(n_lanes)
    lanes = rng.integers(0, 2**32, (500, n_lanes), dtype=np.uint64).astype(np.uint32)
    lanes[:50] = lanes[50:100]  # duplicates
    valid = rng.random(500) < 0.8
    jh = jpacking.hash_pair(jnp.asarray(lanes))
    th = tpacking.hash_pair(torch.from_numpy(lanes.view(np.int32)))
    for j, t in zip(jh, th):
        assert np.array_equal(np.asarray(j).view(np.int32), t.numpy())
    jk = jprocess._folded_key(JKV(jnp.asarray(lanes), jnp.zeros(500, jnp.int32), jnp.asarray(valid)))
    tk = tprocess._folded_key(TKV(torch.from_numpy(lanes.view(np.int32)),
                                  torch.zeros(500, dtype=torch.int32), torch.from_numpy(valid)))
    assert np.array_equal(np.asarray(jk).view(np.int32), tk.numpy())


def test_index_pair_sort_and_dedup_equal_jax():
    """Signed doc values (JAX sorts them as int32): the deduped pairs come
    out in the same order, the survivors' count the same."""
    rng = np.random.default_rng(9)
    pick = rng.integers(0, 40, 600)  # 40 distinct words, each many times
    lanes = rng.integers(0, 2**32, (40, 9), dtype=np.uint64).astype(np.uint32)[pick]
    values = rng.integers(-3, 3, 600).astype(np.int32)
    valid = rng.random(600) < 0.9
    jd, jn = jindex._dedup_sorted_pairs(jindex._sort_pairs(
        JKV(jnp.asarray(lanes), jnp.asarray(values), jnp.asarray(valid))))
    td, tn = tindex._dedup_sorted_pairs(tindex._sort_pairs(
        TKV(torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(values),
            torch.from_numpy(valid))))
    n = int(jn)
    assert int(tn) == n and n < int(valid.sum())
    assert np.array_equal(np.asarray(jd.key_lanes)[:n].view(np.int32), td.key_lanes[:n].numpy())
    assert np.array_equal(np.asarray(jd.values)[:n], td.values[:n].numpy())
    assert td.valid[:n].all() and not td.valid[n:].any()


def test_entry_points_run_on_cuda_by_default(monkeypatch):
    from locust_tpu_torch.plan import compile_plan, index_plan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = TConfig(**KW)
    for call in (lambda: ttfidf.term_doc_counts(LINES, DOCS, tcfg),
                 lambda: ttfidf.build_tfidf(LINES, DOCS, tcfg),
                 lambda: ttfidf.term_doc_counts_stream(iter(()), tcfg),
                 lambda: tindex.build_inverted_index(LINES, DOCS, tcfg),
                 lambda: compile_plan(index_plan(2), tcfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_tfidf_and_pagerank_bits_do_not_depend_on_torch_threads():
    """The port's tests run torch on one intra-op thread (torch_threads):
    the tf-idf scores and PageRank's CPU ranks are the same bits at 1
    and at 4 threads, so the pin hides no order-dependent sum."""
    from locust_tpu_torch.apps.pagerank import pagerank

    lines = _corpus(n_lines=3000, seed=9)
    docs = np.arange(len(lines), dtype=np.int32) // 7
    rng = np.random.default_rng(12)
    n, e = 100_000, 1_000_000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (rng.zipf(1.5, e) % n).astype(np.int32)  # heavy rows, as on a web graph
    got = {}
    try:
        for threads in (1, 4):
            torch.set_num_threads(threads)
            cfg = TConfig(sort_mode="bitonic", **dict(KW, block_lines=512))
            got[threads] = (ttfidf.build_tfidf(lines, docs, cfg, pairs_capacity=1 << 15,
                                               allow_overflow=True, device="cpu"),
                            pagerank(src, dst, n, 5, 0.85, device="cpu").numpy().view(np.uint32))
    finally:
        torch.set_num_threads(1)
    assert got[1][0] == got[4][0] and len(got[1][0]) > 1000
    assert np.array_equal(got[1][1], got[4][1])
