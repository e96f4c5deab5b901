"""The Sort Benchmark's ``gensort -a`` records, made from the run's seed on
the run's device.

Each record is 100 bytes (sortbenchmark.org's ``gensort -a`` layout)::

    bytes  0-9   the key: 10 printable ASCII characters, 0x20-0x7E, uniform
    bytes 10-11  two blanks
    bytes 12-43  the record's number as 32 upper-case hex digits
    bytes 44-45  two blanks
    bytes 46-97  the filler: 13 hex digits, each written four times
    bytes 98-99  CR LF

The keys and the filler's digits are drawn by ``torch``'s generator from
the run's seed (not gensort's 128-bit LCG); the filler's pattern is
assumed, and no byte after the key can change the order.  Records are
made in chunks, so the device holds the draws of one chunk at a time;
the same seed on the same device gives the same records.
"""

from __future__ import annotations

import numpy as np

from benchmark import harness

RECORD_BYTES = 100
KEY_BYTES = 10
# Printable ASCII: the key's 95 characters.
KEY_LO, KEY_HI = 0x20, 0x7E
FILLER_DIGITS = 13
# Records drawn at once.
CHUNK = 1 << 22
# Tells the generator's seed apart from any other stream of the run.
STREAM = 100
HEX = b"0123456789ABCDEF"


def torch_seed(seed: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from the run's seed."""
    rng = np.random.default_rng(harness.seed_words(seed, STREAM))
    return int(rng.integers(0, 2**63 - 1))


def gensort_records(n: int, seed: int, device: str = "cuda", first: int = 0):
    """``[n, 100]`` uint8 records numbered ``first`` .. ``first + n - 1``,
    on ``device``."""
    import torch

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(torch_seed(seed))
    hexd = torch.tensor(list(HEX), dtype=torch.uint8, device=dev)
    shifts = torch.arange(60, -4, -4, device=dev)  # the low 16 hex digits
    out = torch.empty((n, RECORD_BYTES), dtype=torch.uint8, device=dev)
    out[:, 10:12] = ord(" ")
    out[:, 12:28] = ord("0")
    out[:, 44:46] = ord(" ")
    out[:, 98] = ord("\r")
    out[:, 99] = ord("\n")
    for lo in range(0, n, CHUNK):
        k = min(CHUNK, n - lo)
        rows = out[lo:lo + k]
        rows[:, :KEY_BYTES] = torch.randint(KEY_LO, KEY_HI + 1, (k, KEY_BYTES), generator=gen,
                                            device=dev, dtype=torch.uint8)
        number = torch.arange(first + lo, first + lo + k, device=dev)
        rows[:, 28:44] = hexd[(number[:, None] >> shifts) & 0xF]
        filler = torch.randint(0, 16, (k, FILLER_DIGITS), generator=gen, device=dev)
        rows[:, 46:98] = hexd[filler].repeat_interleave(4, dim=1)
    return out
