"""Seeded Zipf corpora: the generator behind the sample input and the
bench's fallback corpus.

The port's own copy of ``locust_tpu/io/corpus.py`` (numpy only): for the
same arguments ``synthetic_corpus`` returns, and ``write_corpus`` writes,
the same bytes as the JAX package's.  A Zipf exponent of ~1.1
approximates natural-language token frequency; the vocabulary size sets
how hard the corpus presses on the accumulator table and on the fused
kernel's per-block table.
"""

from __future__ import annotations

import numpy as np


def synthetic_corpus(
    target_bytes: int,
    n_vocab: int = 30_000,
    seed: int = 0,
    zipf: float = 1.1,
    words_per_line: int = 10,
) -> list[bytes]:
    """Deterministic Zipf corpus of roughly ``target_bytes`` bytes."""
    rng = np.random.default_rng(seed)
    words = np.array([b"w%06d" % i for i in range(n_vocab)], dtype=object)
    lines: list[bytes] = []
    total = 0
    # Draw in chunks; ids follow a REJECTION-sampled Zipf (clipping would
    # pile the entire tail's mass onto one word and distort the skew).
    chunk_tokens = max(1024, words_per_line * 256)
    while total < target_bytes:
        ids = rng.zipf(zipf, size=chunk_tokens * 2) - 1
        ids = ids[ids < n_vocab][:chunk_tokens]
        while ids.size < chunk_tokens:
            more = rng.zipf(zipf, size=chunk_tokens) - 1
            ids = np.concatenate([ids, more[more < n_vocab]])[:chunk_tokens]
        toks = words[ids]
        for i in range(0, chunk_tokens, words_per_line):
            ln = b" ".join(toks[i : i + words_per_line].tolist())
            lines.append(ln)
            total += len(ln) + 1
            if total >= target_bytes:
                break
    return lines


def write_corpus(
    path: str, target_bytes: int, chunk_bytes: int = 16_000_000, **kw
) -> int:
    """Write a generated corpus to ``path`` in bounded memory.

    Generates and appends ``chunk_bytes`` at a time (seed varied per
    chunk so the Zipf draw differs, keeping the corpus deterministic for
    a given target): a multi-GB corpus never materializes in RAM.
    Returns bytes written.
    """
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    seed0 = kw.pop("seed", 0)
    written = 0
    with open(path, "wb") as f:
        chunk_i = 0
        while written < target_bytes:
            want = min(chunk_bytes, target_bytes - written)
            # Decorrelated per-chunk seed: seed0 + chunk_i would make
            # adjacent base seeds produce shifted copies of each other.
            lines = synthetic_corpus(want, seed=seed0 * 1_000_003 + chunk_i, **kw)
            data = b"\n".join(lines) + b"\n"
            f.write(data)
            written += len(data)
            chunk_i += 1
    return written
