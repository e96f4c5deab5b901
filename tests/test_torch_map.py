"""PyTorch port, Map stage: the plain tokenizer and ``wordcount_map`` held
against the JAX ``tokenize_block`` and the JAX Pallas tokenizer kernel in
interpret mode, on the sample corpus and a seeded fuzz of the hard lines
(embedded NUL, CR/LF, tokens longer than key_width, more tokens than
emits_per_line, a token touching the row's end).  Exact equality."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import strtok_tokens
from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.ops import map_stage as jmap
from locust_tpu.ops.pallas.tokenize import tokenize_block_pallas
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.ops import map_stage as tmap
from locust_tpu_torch.ops.kernels.tokenize import tokenize_block_kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(block_lines=64, line_width=128, emits_per_line=8, key_width=16)

HARD_LINES = [
    b"to be or not to be",
    b"a\x00b\x00\x00c",
    b"carriage\rreturn\nnewline\r\n",
    b"x" * 40 + b" short " + b"y" * 17,
    b"one two three four five six seven eight nine ten eleven",
    b" " * 127 + b"z",
    b"q" * 128,
    b"",
    b"hyphen-split 'quoted' (x), y.z;\t\"end\"",
    b"\xff\xfe bytes \x80 high",
]


def _sample_block(start):
    from locust_tpu_torch.io.loader import load_rows

    rows = load_rows(os.path.join(REPO, "data", "sample_corpus.txt"), 128)
    return np.ascontiguousarray(rows[start : start + 64])


def _fuzz_block(seed):
    """64 rows: the hard lines plus seeded random rows biased to
    delimiters, with long runs and tokens up to the row's end."""
    rng = np.random.default_rng(seed)
    rows = bytes_ops.strings_to_rows(HARD_LINES, 128)
    alphabet = np.frombuffer(b"abcdefgh  ,.-\x00\r\n'\"()\t;:Z", np.uint8)
    fuzz = alphabet[rng.integers(0, len(alphabet), (64 - len(rows), 128))]
    long_tok = rng.random(len(fuzz)) < 0.3
    fuzz[long_tok, 60:100] = ord("w")
    return np.concatenate([rows, fuzz])


BLOCKS = {
    "corpus0": lambda: _sample_block(0),
    "corpus400": lambda: _sample_block(400),
    "fuzz1": lambda: _fuzz_block(1),
    "fuzz2": lambda: _fuzz_block(2),
}


@pytest.fixture(scope="module")
def jax_tokenized():
    """JAX results per block: (tokenize_block, Pallas kernel interpret)."""
    jcfg = JConfig(**CFG)
    out = {}
    for name, make in BLOCKS.items():
        rows = jnp.asarray(make())
        ref = jmap.tokenize_block(rows, jcfg)
        kern = tokenize_block_pallas(rows, jcfg, interpret=True)
        out[name] = (
            tuple(np.asarray(x) for x in (ref.keys, ref.valid, ref.overflow)),
            tuple(np.asarray(x) for x in kern),
        )
    return out


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_tokenize_block_equals_jax_and_pallas_kernel(block, jax_tokenized):
    rows = torch.from_numpy(BLOCKS[block]())
    res = tmap.tokenize_block(rows, TConfig(**CFG))
    got = (res.keys.numpy(), res.valid.numpy(), res.overflow.numpy())
    assert res.keys.dtype == torch.uint8 and res.valid.dtype == torch.bool
    assert res.overflow.dtype == torch.int32
    for want in jax_tokenized[block]:
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_kernel_wrapper_on_cpu_is_the_plain_version(block):
    rows = torch.from_numpy(BLOCKS[block]())
    keys, valid, ovf = tokenize_block_kernel(rows, 8, 16)
    ref = tmap.tokenize_block(rows, TConfig(**CFG))
    assert torch.equal(keys, ref.keys) and torch.equal(valid, ref.valid)
    assert int(ovf) == int(ref.overflow)


def test_hard_lines_match_the_strtok_oracle():
    rows = torch.from_numpy(_fuzz_block(0))
    res = tmap.tokenize_block(rows, TConfig(**CFG))
    for i, line in enumerate(HARD_LINES):
        toks = strtok_tokens(line[:128], max_tokens=8, key_width=16)
        got = bytes_ops.rows_to_strings(res.keys[i, : len(toks)].numpy())
        assert got == toks, i
        assert int(res.valid[i].sum()) == len(toks)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_wordcount_map_equals_jax(use_pallas):
    rows = _fuzz_block(5)
    jkv, jovf = jmap.wordcount_map(jnp.asarray(rows), JConfig(**CFG, use_pallas=use_pallas))
    tkv, tovf = tmap.wordcount_map(torch.from_numpy(rows), TConfig(**CFG, use_pallas=use_pallas))
    assert np.array_equal(tkv.key_lanes.numpy().view(np.uint32), np.asarray(jkv.key_lanes))
    assert np.array_equal(tkv.values.numpy(), np.asarray(jkv.values))
    assert np.array_equal(tkv.valid.numpy(), np.asarray(jkv.valid))
    assert int(tovf) == int(jovf)
