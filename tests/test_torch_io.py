"""PyTorch port, host I/O against the JAX package: the intermediate
serde (files byte for byte the JAX writer's, reads equal, the same
refusals), ``fingerprint_corpus``, npz tables read across packages,
``StreamingCorpus`` blocks and ``fingerprint()``, the caps helpers behind
``--auto-caps``, ``count_lines``, ``prefetch_blocks`` and the snapshot
writer."""

import os
import threading

import numpy as np
import pytest
import torch

from locust_tpu.io import loader as jloader
from locust_tpu.io import serde as jserde
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.io import loader as tloader
from locust_tpu_torch.io import serde as tserde
from locust_tpu_torch.io.snapshot import AsyncCheckpointWriter, finalize_snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "sample_corpus.txt")

PAIRS = [(b"alpha", 3), (b"b", -7), (b"\xc3\xa9t\xc3\xa9", 2**31 - 1), (b"x" * 40, -(2**31)),
         (b"zz top", 0)]


@pytest.mark.parametrize("pairs", [PAIRS, [], [(b"k%04d" % i, i * 7 - 300) for i in range(500)]],
                         ids=["mixed", "empty", "many"])
@pytest.mark.parametrize("fmt", ["tsv", "bin"])
def test_intermediate_files_byte_identical(fmt, pairs, tmp_path):
    jserde.write_intermediate(pairs, str(tmp_path / "j"), fmt)
    tserde.write_intermediate(pairs, str(tmp_path / "t"), fmt)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    assert tserde.is_kvbin(str(tmp_path / "t")) == jserde.is_kvbin(str(tmp_path / "j")) == (fmt == "bin")
    for kw in (8, 32):
        tk, tv = tserde.read_intermediate(str(tmp_path / "t"), kw)
        jk, jv = jserde.read_intermediate(str(tmp_path / "j"), kw)
        assert np.array_equal(tk, jk) and np.array_equal(tv, jv) and tv.dtype == np.int32


def test_tsv_reads_reference_style_and_malformed_rows(tmp_path):
    p = tmp_path / "ref.tsv"
    p.write_bytes(b"word \t5\n\nother\t 12 \r\nbad\t1_2\n\tnokey 3\nneg\t-4\nlong\t"
                  + b"9" * 70 + b"\ntrail \t7")
    for kw in (4, 16):
        tk, tv = tserde.read_tsv(str(p), kw)
        jk, jv = jserde.read_tsv(str(p), kw, use_native=False)
        assert np.array_equal(tk, jk) and np.array_equal(tv, jv)
    assert tv.tolist() == [5, 12, -4, 7]
    p.write_bytes(b"big\t2147483648\n")
    with pytest.raises(OverflowError):
        tserde.read_tsv(str(p), 8)


def test_kvbin_refusals_match_jax(tmp_path):
    good = tmp_path / "g.bin"
    tserde.write_kvbin(PAIRS, str(good))
    data = good.read_bytes()
    cases = {"magic": b"XKVB" + data[4:], "version": data[:4] + b"\x02" + data[5:],
             "size": data[:-1], "header": data[:10]}
    for name, blob in cases.items():
        p = tmp_path / name
        p.write_bytes(blob)
        with pytest.raises(ValueError) as t_err:
            tserde.read_kvbin(str(p), 16)
        with pytest.raises(ValueError) as j_err:
            jserde.read_kvbin(str(p), 16)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(OverflowError):
        tserde.write_kvbin([(b"a", 2**31)], str(tmp_path / "o.bin"))
    with pytest.raises(ValueError, match="u16"):
        tserde.write_kvbin([(b"a" * 70000, 1)], str(tmp_path / "o.bin"))
    with pytest.raises(ValueError, match="unknown intermediate format"):
        tserde.write_intermediate(PAIRS, str(tmp_path / "o"), "csv")


def test_fingerprint_corpus_and_npz_across_packages(tmp_path):
    rows = tloader.load_rows(CORPUS, 128)
    kw = dict(cfg="EngineConfig(...)", combine="sum", map_fn="wordcount_map")
    assert tserde.fingerprint_corpus(rows, **kw) == jserde.fingerprint_corpus(rows, **kw)
    assert tserde.fingerprint_corpus(rows[:-1], **kw) != jserde.fingerprint_corpus(rows, **kw)
    rng = np.random.default_rng(3)
    lanes = rng.integers(-(2**31), 2**31, (64, 8)).astype(np.int32)
    batch = KVBatch(torch.from_numpy(lanes), torch.arange(64, dtype=torch.int32),
                    torch.from_numpy(rng.random(64) > 0.5))
    tserde.write_npz(batch, str(tmp_path / "t.npz"))
    j = jserde.read_npz(str(tmp_path / "t.npz"))
    assert np.array_equal(np.asarray(j.key_lanes), lanes.view(np.uint32))
    jserde.write_npz(j, str(tmp_path / "j.npz"))
    back = tserde.read_npz(str(tmp_path / "j.npz"))
    for a, b in zip((back.key_lanes, back.values, back.valid), (batch.key_lanes, batch.values, batch.valid)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    """CRLF and LF lines, a blank line, a 70,000-byte line (past the
    64 KiB read window) and no final newline."""
    rng = np.random.default_rng(11)
    words = [b"w%d" % i for i in range(300)]
    lines = [b" ".join(words[j] for j in rng.integers(0, 300, rng.integers(0, 30)))
             for _ in range(3000)]
    lines[5] = b""
    lines[1200] = b"long " * 14000
    body = b"".join(ln + (b"\r\n" if i % 3 == 0 else b"\n") for i, ln in enumerate(lines))
    p = tmp_path_factory.mktemp("corpus") / "c.txt"
    p.write_bytes(body + b"tail words")
    return str(p)


@pytest.mark.parametrize("start,end,bl", [(-1, -1, 256), (100, 2000, 333), (2990, -1, 64),
                                          (0, 5, 4), (5000, -1, 16)])
def test_streaming_corpus_equals_jax(corpus_file, start, end, bl):
    t = tloader.StreamingCorpus(corpus_file, 128, bl, start, end, chunk_bytes=1 << 16)
    for native in (False, True):
        j = jloader.StreamingCorpus(corpus_file, 128, bl, start, end, chunk_bytes=1 << 16,
                                    use_native=native)
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb)
        assert all(np.array_equal(a, b) for a, b in zip(tb, jb))
        assert t.fingerprint() == j.fingerprint()
    if tb:
        want = tloader.load_rows(corpus_file, 128, start, end)
        assert np.array_equal(np.concatenate(tb), want)
    assert tloader.count_lines(corpus_file) == jloader.count_lines(corpus_file) == 3001


def test_caps_helpers_equal_jax(corpus_file):
    lines = tloader.load_lines(corpus_file)
    rows = tloader.load_rows(corpus_file, 128)
    row_bytes = [r.tobytes() for r in rows]
    assert tloader.measure_caps(row_bytes) == jloader.measure_caps(row_bytes)
    assert tloader.count_distinct_tokens(lines) == jloader.count_distinct_tokens(lines)
    assert tloader.auto_caps(lines, 32, 20) == jloader.auto_caps(lines, 32, 20)
    assert tloader.auto_caps(lines, 16, 4) == jloader.auto_caps(lines, 16, 4)
    blocks = [rows[i:i + 100] for i in range(0, len(rows), 100)]
    assert tloader.measure_caps_rows(blocks) == jloader.measure_caps_rows(blocks)
    stream_t = tloader.StreamingCorpus(corpus_file, 128, 256, 10, 2500)
    stream_j = jloader.StreamingCorpus(corpus_file, 128, 256, 10, 2500)
    assert tloader.measure_caps_stream(stream_t) == jloader.measure_caps_stream(stream_j)
    for args in ((3, 2, 32, 20), (40, 30, 32, 20), (9, 1, 64, 8)):
        assert tloader.size_caps(*args) == jloader.size_caps(*args)


class _Boom(RuntimeError):
    pass


def test_prefetch_blocks_order_errors_and_close():
    assert list(tloader.prefetch_blocks(iter(range(50)), depth=3)) == list(range(50))

    def failing():
        yield 1
        raise _Boom("source failed")

    it = tloader.prefetch_blocks(failing())
    assert next(it) == 1
    with pytest.raises(_Boom):
        next(it)
    before = threading.active_count()
    it = tloader.prefetch_blocks(iter(range(10**6)), depth=2)
    assert next(it) == 0
    it.close()  # abandoning stops the reader thread
    assert threading.active_count() <= before


def test_snapshot_writer_latest_wins_and_errors(tmp_path):
    started, gate = threading.Event(), threading.Event()
    done = []
    w = AsyncCheckpointWriter()
    try:
        w.submit(1, lambda: (started.set(), gate.wait(10), done.append(1)))
        assert started.wait(10)  # generation 1 is being written
        for g in (2, 3, 4):
            w.submit(g, lambda g=g: done.append(g))
        gate.set()
        assert w.flush()
        assert done == [1, 4]
        st = w.stats()
        assert st == {"submitted": 4, "written": 2, "skipped": 2, "abandoned": 0, "max_lag": 3}

        def fail():
            raise OSError("disk full")

        w.submit(5, fail)
        with pytest.raises(OSError, match="disk full"):
            w.flush()
    finally:
        w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(6, lambda: None)
    (tmp_path / "s.tmp").write_bytes(b"one")
    finalize_snapshot(str(tmp_path / "s.tmp"), str(tmp_path / "s"))
    (tmp_path / "s.tmp").write_bytes(b"two")
    finalize_snapshot(str(tmp_path / "s.tmp"), str(tmp_path / "s"), prev_path=str(tmp_path / "s.prev"))
    assert (tmp_path / "s").read_bytes() == b"two" and (tmp_path / "s.prev").read_bytes() == b"one"
    assert not (tmp_path / "s.tmp").exists()
