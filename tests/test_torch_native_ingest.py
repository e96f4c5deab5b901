"""PyTorch port, the native reader (``csrc/ingest.cpp`` via
``io/native_ingest.py``): byte for byte the JAX package's native reader
and its Python paths, through ``load_rows``, ``StreamingCorpus``,
``measure_caps_stream`` and ``read_tsv``; an error after a block was
yielded propagates; a failed build raises ``OSError``, never falls back.
The reader is host code built with g++, so these tests build and run the
real library on the CPU."""

import numpy as np
import pytest

from locust_tpu.io import loader as jloader
from locust_tpu.io import native_ingest as jnative
from locust_tpu.io import serde as jserde
from locust_tpu_torch import _build
from locust_tpu_torch.io import loader as tloader
from locust_tpu_torch.io import native_ingest as tnative
from locust_tpu_torch.io import serde as tserde

CORPUS = b"first line\nsecond, line\nthird-line\r\nfourth\nlast without newline"
SLICES = [(-1, -1), (1, 3), (0, 2), (4, 99), (2, 2), (99, 200), (3, -1)]


@pytest.fixture
def corpus_file(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(CORPUS)
    return str(p)


@pytest.fixture
def stress_file(tmp_path):
    """Lines across every chunk boundary, one far beyond the 64 KiB test
    chunk and the 1 MB native buffer, empty lines and CR semantics."""
    p = tmp_path / "stress.txt"
    lines = [b"x" * n for n in (0, 1, 31, 32, 33, 200_000, 0, 5)]
    lines += [b"a\rb", b"crlf\r", b"two\r\r", b"y" * 31 + b"\r" + b"zzz", b"w" * 1_500_000]
    p.write_bytes(b"\n".join(lines) + b"\ntail")
    return str(p)


def _stream(mod, path, width, block_lines, start=-1, end=-1, use_native=True):
    sc = mod.StreamingCorpus(path, width, block_lines, start, end, chunk_bytes=1 << 16,
                             use_native=use_native)
    return list(sc)


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("sl", SLICES)
def test_load_rows_equals_jax(corpus_file, width, sl):
    got = tloader.load_rows(corpus_file, width, *sl)
    np.testing.assert_array_equal(got, jnative.load_rows(corpus_file, width, *sl))
    np.testing.assert_array_equal(got, jloader.load_rows(corpus_file, width, *sl, use_native=False))
    np.testing.assert_array_equal(got, tloader.load_rows(corpus_file, width, *sl, use_native=False))
    assert got.dtype == np.uint8 and got.shape[1] == width


def test_count_lines_and_long_line(stress_file):
    assert tnative.count_lines(stress_file) == jnative.count_lines(stress_file) == \
        tloader.count_lines(stress_file)
    np.testing.assert_array_equal(tloader.load_rows(stress_file, 64),
                                  jloader.load_rows(stress_file, 64, use_native=False))


@pytest.mark.parametrize("block_lines", [1, 2, 3, 100])
def test_streaming_corpus_blocks_equal_jax(corpus_file, block_lines):
    got = _stream(tloader, corpus_file, 32, block_lines)
    for want in (_stream(jloader, corpus_file, 32, block_lines),
                 _stream(jloader, corpus_file, 32, block_lines, use_native=False),
                 _stream(tloader, corpus_file, 32, block_lines, use_native=False)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert all(b.shape[0] == block_lines for b in got[:-1])


@pytest.mark.parametrize("sl", [(1, 3), (3, 100), (99, 200), (0, 0), (2, -1)])
def test_streaming_corpus_slices_equal_jax(corpus_file, sl):
    got = _stream(tloader, corpus_file, 32, 2, *sl)
    want = _stream(jloader, corpus_file, 32, 2, *sl, use_native=False)
    assert [b.tobytes() for b in got] == [b.tobytes() for b in want]


@pytest.mark.parametrize("width", [8, 32])
def test_chunk_boundaries_long_lines_and_cr(stress_file, width):
    """The windowed scanner against the Python chunked reader and JAX's
    native scanner: every line cut to the width, exactly one CR of a
    CRLF stripped, a CR at the cut position kept as data."""
    got = np.concatenate(_stream(tloader, stress_file, width, 3))
    np.testing.assert_array_equal(got, np.concatenate(_stream(jloader, stress_file, width, 3)))
    np.testing.assert_array_equal(
        got, np.concatenate(_stream(tloader, stress_file, width, 3, use_native=False)))
    np.testing.assert_array_equal(got, jloader.load_rows(stress_file, width, use_native=False))


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("sl", [(-1, -1), (3, 60), (0, 1)])
def test_measure_caps_stream_equals_jax(tmp_path, width, sl):
    rng = np.random.default_rng(5)
    alphabet = list(b"abcdef ,.-;:'()\"\t\r\x00")
    lines = [bytes(rng.choice(alphabet, size=int(rng.integers(0, 200)))) for _ in range(120)]
    lines += [b"", b"x" * 500, b"tok " * 60, b"y" * 127 + b" zz", b"w" * 128 + b"qq more"]
    p = tmp_path / "caps.txt"
    p.write_bytes(b"\n".join(lines) + b"\ntail_without_newline")
    got = tloader.measure_caps_stream(tloader.StreamingCorpus(str(p), width, 16, *sl))
    assert got == tnative.measure_caps(str(p), width, *sl) == jnative.measure_caps(str(p), width, *sl)
    for use_native in (False, True):
        want = jloader.measure_caps_stream(
            jloader.StreamingCorpus(str(p), width, 16, *sl, use_native=use_native))
        assert got == want
    py = tloader.measure_caps_stream(tloader.StreamingCorpus(str(p), width, 16, *sl,
                                                             use_native=False))
    assert got == py


TSV_CASES = [
    b"word\t3\nother\t-7\n",
    b"key \t5\n",
    b"a b \t5\nab c\t6\n",
    b"\nword\t1\n\n",
    b"noval\nword\t2\n",
    b"word\tnotint\nok\t9\n",
    b"word\t 12 \n",
    b"word\t5",
    b"crlf\t4\r\n",
    b"verylongkey_beyond_width\t8\n",
    b"  \t5\n",
    b"tab\t5\t6\n",
    b"",
    b"u\t1_2\nok\t3\n",
    b"v\t5\x0b\nok\t3\n",
    b"n\t5\x006\nok\t3\n",
    b"L\t" + b" " * 70 + b"5\nok\t3\n",
    b"z\t+7\nneg\t-0\n",
    b"lead\t0005\n",
    b"edge\t" + b" " * 62 + b"5\r\n",
    b"crs\t5" + b"\r" * 80 + b"\n",
    b"icr\t \r 5\nok\t1\n",
]


@pytest.mark.parametrize("case", range(len(TSV_CASES)))
def test_read_tsv_equals_jax(tmp_path, case):
    p = tmp_path / "t.tsv"
    p.write_bytes(TSV_CASES[case])
    for width in (8, 32):
        nk, nv = tserde.read_tsv(str(p), width)
        for wk, wv in (jnative.read_tsv(str(p), width),
                       jserde.read_tsv(str(p), width, use_native=False),
                       tserde.read_tsv(str(p), width, use_native=False)):
            np.testing.assert_array_equal(nk, wk)
            np.testing.assert_array_equal(nv, wv)
        assert nv.dtype == np.int32


def test_read_tsv_int32_overflow_raises(tmp_path):
    p = tmp_path / "o.tsv"
    p.write_bytes(b"word\t3000000000\n")
    for use_native in (True, False):
        with pytest.raises(OverflowError):
            tserde.read_tsv(str(p), 16, use_native=use_native)
    with pytest.raises(OverflowError):
        jnative.read_tsv(str(p), 16)


def test_read_tsv_wide_keys_take_the_python_parser(tmp_path, monkeypatch):
    """Past 256 key bytes the native parser's key buffer ends: the width
    rule sends the read to the Python parser, with the same result as
    JAX's."""
    p = tmp_path / "w.tsv"
    p.write_bytes(b"k" * 300 + b"\t4\nshort\t2\n")

    def refuse(*_a, **_k):
        raise AssertionError("the native parser was called for a 320-byte key")

    monkeypatch.setattr(tnative, "read_tsv", refuse)
    k, v = tserde.read_intermediate(str(p), 320)
    wk, wv = jserde.read_tsv(str(p), 320)
    np.testing.assert_array_equal(k, wk)
    np.testing.assert_array_equal(v, wv)


def test_read_intermediate_stage1_file(tmp_path):
    pairs = [(b"w%05d" % i, i * 7 - 3) for i in range(5000)]
    p = tmp_path / "big.tsv"
    tserde.write_tsv(pairs, str(p))
    k, v = tserde.read_intermediate(str(p), 32)
    wk, wv = jserde.read_intermediate(str(p), 32, use_native=False)
    np.testing.assert_array_equal(k, wk)
    np.testing.assert_array_equal(v, wv)
    assert len(v) == 5000


def test_mid_stream_error_propagates(corpus_file, monkeypatch):
    """An error after a block was yielded reaches the caller; the file is
    never read again from the top (that would fold every block twice)."""
    real = tnative.iter_blocks
    calls = []

    def failing(*args, **kwargs):
        calls.append(args)
        it = real(*args, **kwargs)
        yield next(it)
        raise OSError("disk went away")

    monkeypatch.setattr(tnative, "iter_blocks", failing)
    monkeypatch.setattr(tloader.StreamingCorpus, "_iter_python",
                        lambda self: pytest.fail("fell back to the Python reader"))
    it = iter(tloader.StreamingCorpus(corpus_file, 32, 2))
    first = next(it)
    assert first.shape == (2, 32)
    with pytest.raises(OSError, match="disk went away"):
        list(it)
    assert len(calls) == 1


def test_broken_compiler_raises_oserror_without_fallback(tmp_path, corpus_file, monkeypatch):
    """A native build that fails raises OSError with the compiler's
    output, from every reader, and the Python reader is not taken."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setitem(_build._libs, "ingest", None)
    del _build._libs["ingest"]
    gxx = tmp_path / "g++"
    gxx.write_text("#!/bin/sh\necho 'ingest.cpp:1: error: no compiler here' >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tloader, "bytes_ops", None)  # any Python-path use would fail loudly
    for call in (lambda: tloader.load_rows(corpus_file, 32),
                 lambda: list(tloader.StreamingCorpus(corpus_file, 32, 2)),
                 lambda: tloader.measure_caps_stream(tloader.StreamingCorpus(corpus_file, 32, 2)),
                 lambda: tserde.read_tsv(corpus_file, 32)):
        with pytest.raises(OSError, match="no compiler here"):
            call()
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_compiler_raises_oserror(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(OSError, match="g\\+\\+ not found"):
        _build.build_host()


def test_host_library_path_is_keyed_by_the_source(tmp_path, monkeypatch):
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path("ingest")
    assert before.parent == _build.BUILD_DIR and before.name.startswith("libingest-")
    assert _build.HOST_SOURCES == ("ingest",)
    assert "ingest" not in _build.KERNEL_SOURCES
    with open(csrc / "ingest.cpp", "a") as f:
        f.write("\n")
    assert _build.library_path("ingest") != before
