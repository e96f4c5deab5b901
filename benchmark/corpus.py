"""Seeded Zipf text, generated vectorised.

Frozen copy of the shape of ``locust_tpu_torch/io/corpus.py``
``synthetic_corpus`` (itself the JAX package's generator): words
``w%06d`` of a ``vocab``-word vocabulary, drawn from a Zipf law of
exponent ``zipf`` truncated to the vocabulary (the original rejects draws
past it, which is the same distribution), ``words_per_line`` words a
line joined by one space, each line ending in ``\\n``.  The original loops
in Python (17.9 s for 256 MiB); this one draws every word at once by the
inverse of the truncated law's distribution function.  Its bytes differ
from the original's for the same seed; its law and line shape do not.

A configuration's corpus is ``corpus_bytes`` bytes in ``corpus.parts``
equal parts, each drawn from ``(seed, part)``: part 0 of a many-part
corpus is the one-part corpus of the same seed.
"""

from __future__ import annotations

import numpy as np


def _word_bytes(vocab: int) -> np.ndarray:
    """The vocabulary as a ``[vocab, width]`` uint8 array."""
    words = np.frombuffer(b"".join(b"w%06d" % i for i in range(vocab)), np.uint8)
    return words.reshape(vocab, -1)


def _zipf_cdf(vocab: int, zipf: float) -> np.ndarray:
    weights = np.arange(1, vocab + 1, dtype=np.float64) ** -zipf
    cdf = np.cumsum(weights)
    return cdf / cdf[-1]


def line_bytes(corpus: dict) -> int:
    """Bytes of one line of the corpus described by ``corpus``."""
    word = len(b"w%06d" % (corpus["vocab"] - 1))
    return corpus["words_per_line"] * (word + 1)


def part_bytes(config: dict) -> int:
    return config["corpus_bytes"] // config["corpus"]["parts"]


def generate_part(config: dict, seed: int, part: int) -> bytes:
    """Part ``part`` of the configuration's corpus for ``seed``: whole
    lines, ``corpus_bytes / parts`` bytes."""
    from benchmark.harness import seed_words

    corpus = config["corpus"]
    per_line = line_bytes(corpus)
    size = part_bytes(config)
    if size % per_line or size * corpus["parts"] != config["corpus_bytes"]:
        raise ValueError(f"corpus_bytes {config['corpus_bytes']} is not {corpus['parts']} "
                         f"parts of whole {per_line}-byte lines")
    lines = size // per_line
    wpl = corpus["words_per_line"]
    rng = np.random.default_rng(seed_words(seed, part))
    cdf = _zipf_cdf(corpus["vocab"], corpus["zipf"])
    ids = np.searchsorted(cdf, rng.random(lines * wpl), side="right")
    np.minimum(ids, corpus["vocab"] - 1, out=ids)  # a draw of exactly 1.0
    words = _word_bytes(corpus["vocab"])
    out = np.empty((lines, wpl, words.shape[1] + 1), np.uint8)
    out[:, :, :-1] = words[ids.reshape(lines, wpl)]
    out[:, :, -1] = ord(" ")
    out[:, -1, -1] = ord("\n")
    return out.tobytes()


def write_corpus(path: str, config: dict, seed: int) -> int:
    """Write every part of the configuration's corpus for ``seed`` to
    ``path``; returns the bytes written."""
    total = 0
    with open(path, "wb") as f:
        for part in range(config["corpus"]["parts"]):
            data = generate_part(config, seed, part)
            f.write(data)
            total += len(data)
    return total
