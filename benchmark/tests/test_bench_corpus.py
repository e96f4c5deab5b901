"""The vectorised Zipf generator: fixed by the seed, different across
seeds, the configured shape, part 0 of a many-part corpus the one-part
corpus."""

import copy

import numpy as np
import pytest

from benchmark import corpus, harness

MAN = harness.manifest()
_, ONE, _ = harness.resolve(MAN, "wc-zipf30k-batch")
FOUR = copy.deepcopy(ONE)
FOUR["corpus"]["parts"] = 4
FOUR["corpus_bytes"] *= 4


def small(config, lines=3000):
    c = copy.deepcopy(config)
    c["corpus_bytes"] = 80 * lines * c["corpus"]["parts"]
    return c


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, 2**70 + 1, -5])
def test_deterministic_per_seed(seed):
    c = small(ONE)
    assert corpus.generate_part(c, seed, 0) == corpus.generate_part(c, seed, 0)


def test_seeds_and_parts_differ():
    c = small(FOUR)
    a, b = corpus.generate_part(c, 5, 0), corpus.generate_part(c, 6, 0)
    assert a != b and corpus.generate_part(c, 5, 1) != a
    assert corpus.generate_part(c, -5, 0) != a


def test_shape_and_law():
    c = small(ONE, 20000)
    text = corpus.generate_part(c, 9, 0)
    assert len(text) == c["corpus_bytes"]
    lines = text.split(b"\n")[:-1]
    assert len(lines) == 20000 and {len(ln) for ln in lines} == {79}
    words = text.split()
    assert {len(w) for w in words} == {7} and len(words) == 200000
    ids = np.array([int(w[1:]) for w in words])
    assert ids.max() < c["corpus"]["vocab"]
    counts = np.bincount(ids, minlength=4)
    # Zipf s = 1.1 over 30,000 words: the first word ~14%, twice the second's 2^-1.1.
    assert 0.12 < counts[0] / ids.size < 0.16
    assert 1.9 < counts[0] / counts[1] < 2.4


def test_part_zero_is_the_one_part_text(tmp_path):
    one, four = small(ONE), small(FOUR)
    path = tmp_path / "c.txt"
    assert corpus.write_corpus(str(path), four, 3) == four["corpus_bytes"]
    assert path.read_bytes()[:one["corpus_bytes"]] == corpus.generate_part(one, 3, 0)
    assert ONE["corpus_bytes"] * 4 == FOUR["corpus_bytes"]
