"""PyTorch port, the bit-mask arithmetic of the tokenizer kernels.

``csrc/tokenize.cuh`` (kernel A's and kernel C's line tokenizer) cuts a
line into tokens with bit masks: a group of lanes per line, each lane a
64-bit-or-narrower mask of the bytes inside a token, the start carry from
the previous lane, a ``popc`` prefix for token ids, ``ffs`` of the
delimiter bits (or a later lane's first delimiter) for the token end, and
a writer that assembles each key unit from the row with funnel shifts.
The numpy model below runs those steps lane by lane, with the geometry
the wrapper passes (``line_geometry``), and must give exactly
``tokenize_reference``'s keys, valid and overflow on seeded fuzz blocks
of any width up to 2048 (not only multiples of 16), and exactly the JAX
Pallas tokenizer's in interpret mode where JAX takes the shape (widths a
multiple of 128, 64-line blocks).  The writer must cover every key byte
once and read no byte past the row buffer."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.ops.pallas.tokenize import tokenize_block_pallas
from locust_tpu_torch.config import FULL_DELIMITERS
from locust_tpu_torch.ops.kernels.tokenize import line_geometry, tokenize_reference

IS_DELIM = np.zeros(256, bool)
IS_DELIM[list(FULL_DELIMITERS)] = True
GARBAGE = 0xA5  # shared memory past the lanes' chunks: never part of a key


def _ffs(x: int) -> int:
    """1 + index of the lowest set bit (0 for none), as CUDA's __ffs."""
    return (x & -x).bit_length()


def _word(row: np.ndarray, i: int) -> int:
    assert 0 <= i and 4 * i + 4 <= len(row), "read past the row buffer"
    return int.from_bytes(row[4 * i:4 * i + 4].tobytes(), "little")


def _gather_unit(row, sw, kb, nw):
    """gather_unit: little-endian words of key bytes [kb, kb + 4 nw)."""
    n = (sw >> 16) - kb
    if n <= 0:
        return [0] * nw
    a = (sw & 0xFFFF) + kb
    x = [_word(row, (a >> 2) + i) for i in range(nw + 1)]
    sh = 8 * (a & 3)
    out = []
    for i in range(nw):
        v = (((x[i + 1] << 32) | x[i]) >> sh) & 0xFFFFFFFF  # __funnelshift_r
        nb = n - 4 * i
        out.append(0 if nb <= 0 else v if nb >= 4 else v & ((1 << (8 * nb)) - 1))
    return out


def model_line(line: np.ndarray, emits: int, key_width: int):
    """One line through group_tokenize and the kernel's writer; returns
    (keys [E, K], ntok)."""
    width = len(line)
    g_log, chunks = line_geometry(width)
    lanes, span = 1 << g_log, 16 * chunks
    row = np.full(lanes * span + 32, GARBAGE, np.uint8)
    row[:lanes * span] = 0
    row[:width] = line
    span_mask = (1 << span) - 1

    # Per lane: the in-token mask, 4 bytes at a time through the set.
    ins = []
    for g in range(lanes):
        b0, m = g * span, 0
        for j in range(span // 4):
            w = _word(row, b0 // 4 + j)
            bits = sum((not IS_DELIM[(w >> (8 * i)) & 0xFF]) << i for i in range(4))
            m |= bits << (4 * j)
        live_bytes = min(max(width - b0, 0), span)
        ins.append(m & ((1 << live_bytes) - 1))
    carry = [0] + [(ins[g - 1] >> (span - 1)) & 1 for g in range(1, lanes)]
    starts = [ins[g] & ~((ins[g] << 1) | carry[g]) & span_mask for g in range(lanes)]
    counts = [bin(s).count("1") for s in starts]
    incl = np.cumsum(counts).tolist()
    ntok = incl[-1]
    delims = [~ins[g] & span_mask for g in range(lanes)]
    first = [g * span + _ffs(d) - 1 if d else 1 << 30 for g, d in enumerate(delims)]
    first[-1] = min(first[-1], lanes * span)  # the end of the lanes' bytes
    suffix = [min(first[g:]) for g in range(lanes)]
    after = suffix[1:] + [lanes * span]

    slot = {}
    for g in range(lanes):
        b0, tid, s = g * span, incl[g] - counts[g], starts[g]
        while s and tid < emits:
            p = _ffs(s) - 1
            s &= s - 1
            rest = delims[g] >> p
            end = b0 + p + _ffs(rest) - 1 if rest else after[g]
            slot[tid] = (b0 + p) | min(end - b0 - p, key_width) << 16
            tid += 1
    assert sorted(slot) == list(range(min(ntok, emits)))

    # The writer: lane g takes units g, g + G, ... with (e, u) advanced by
    # divmod(G, units); every unit written exactly once.
    nw = 4 if key_width % 16 == 0 else 2 if key_width % 8 == 0 else 1
    units = key_width // (4 * nw)
    step_e, step_u = divmod(lanes, units)
    keys = np.zeros((emits, key_width), np.uint8)
    seen = np.zeros((emits, units), np.int64)
    for g in range(lanes):
        e, u = divmod(g, units)
        while e < emits:
            words = _gather_unit(row, slot.get(e, 0), u * 4 * nw, nw)
            keys[e, u * 4 * nw:(u + 1) * 4 * nw] = np.frombuffer(
                b"".join(w.to_bytes(4, "little") for w in words), np.uint8)
            seen[e, u] += 1
            e, u = e + step_e, u + step_u
            if u >= units:
                e, u = e + 1, u - units
    assert (seen == 1).all()
    return keys, ntok


def model_tokenize(rows: np.ndarray, emits: int, key_width: int):
    keys, ntoks = zip(*(model_line(r, emits, key_width) for r in rows))
    ntok = np.array(ntoks)
    valid = np.arange(emits)[None, :] < np.minimum(ntok, emits)[:, None]
    return np.stack(keys), valid, int(np.maximum(ntok - emits, 0).sum())


def _block(seed: int, lines: int, width: int) -> np.ndarray:
    """Seeded rows biased to delimiters, with the hard rows first: no
    delimiter, delimiters only, tokens across 16-byte boundaries, bytes
    >= 0x80, a token up to the row end."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefgh  ,.-\x00\r\n'\"()\t;:Z\x80\xe9\xff", np.uint8)
    rows = alphabet[rng.integers(0, len(alphabet), (lines, width))]
    rows[rng.random(lines) < 0.3, width // 3:width // 3 + 40] = ord("w")
    hard = [np.full(width, ord("x")), np.full(width, ord(" ")),
            np.resize(np.frombuffer(b"abcdefghijklmn o", np.uint8)[::-1], width),
            np.resize(np.frombuffer(b"\xc3\xa9t\xe9 \x80\x81\x82.", np.uint8), width)]
    for i, r in enumerate(hard[:lines]):
        rows[i] = r
    if lines > 4:
        rows[4, :] = ord(",")
        rows[4, -min(width, 20):] = ord("q")
    return rows


# (width, lines, emits, key_width): widths not multiples of 16 and below 16
# included; the main path's 128 / 20 / 32; E 1 and 256; K 4 (4-byte units),
# 8 (8-byte units) and 64.
CASES = [
    (1, 40, 20, 32), (15, 40, 20, 32), (16, 24, 3, 4), (33, 40, 20, 32),
    (100, 40, 20, 32), (128, 64, 20, 32), (128, 64, 6, 16), (128, 64, 1, 16), (128, 64, 256, 4),
    (129, 24, 8, 64), (200, 24, 20, 8), (512, 16, 20, 36), (2048, 8, 256, 64),
]


@functools.lru_cache(maxsize=None)
def _case(width, lines, emits, key_width):
    rows = _block(width * 7 + emits, lines, width)
    return rows, model_tokenize(rows, emits, key_width)


@pytest.mark.parametrize("width,lines,emits,key_width", CASES)
def test_bit_model_equals_reference(width, lines, emits, key_width):
    rows, (keys, valid, ovf) = _case(width, lines, emits, key_width)
    rk, rv, ro = tokenize_reference(torch.from_numpy(rows), emits, key_width)
    assert np.array_equal(keys, rk.numpy())
    assert np.array_equal(valid, rv.numpy())
    assert ovf == int(ro)


# JAX's gate: widths a multiple of 128, blocks of 64 lines.
JAX_CASES = [(128, 64, 6, 16), (128, 64, 1, 16), (256, 64, 4, 8)]


@pytest.mark.parametrize("width,lines,emits,key_width", JAX_CASES)
def test_bit_model_equals_jax_pallas_kernel(width, lines, emits, key_width):
    rows, (keys, valid, ovf) = _case(width, lines, emits, key_width)
    cfg = JConfig(block_lines=lines, line_width=width, emits_per_line=emits, key_width=key_width)
    jk, jv, jo = tokenize_block_pallas(jnp.asarray(rows), cfg, interpret=True)
    assert np.array_equal(keys, np.asarray(jk))
    assert np.array_equal(valid, np.asarray(jv))
    assert ovf == int(jo)


def test_line_geometry_covers_every_width():
    for width in range(1, 2049):
        g_log, chunks = line_geometry(width)
        lanes = 1 << g_log
        assert 0 <= g_log <= 5 and 1 <= chunks <= 4
        assert 16 * chunks * lanes >= width
        # The fewest lanes up to 32, then the fewest chunks.
        assert lanes == 1 or 16 * chunks * (lanes // 2) < width
        assert 16 * (chunks - 1) * lanes < width
    assert line_geometry(128) == (3, 1)  # 8 lanes x 16 bytes: 4 lines a warp
    assert line_geometry(2048) == (5, 4)
