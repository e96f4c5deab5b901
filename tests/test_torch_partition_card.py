"""PyTorch port, the shuffle's stable counting partition kernel
(``csrc/partition.cu``) on a card against its plain version on the CPU,
slot for slot: the bins and the leftover (every word, empty slots
included), the overflow, each bin's total, and the payload byte for byte
in every filled bin slot (the kernel leaves an empty slot's payload
unwritten).  At 1, 2,
4, 7 and 64 bins; skewed buckets whose bins spill into a leftover, with
none, and past it; invalid rows and buckets out of range scattered through
the batch; row counts that are not a multiple of the kernel's tile;
payloads of 25 four-byte words (the sample sort's 100-byte records), of
int64 words (copied as 4-byte words), and none; a batch of no rows, with a
payload and without.  Also each
call's one launch in the wrapper's count and in the counter
``shuffle.partition_launches``.

The tests need a CUDA card and skip without one; on the card run
``python -m pytest --noconftest tests/test_torch_partition_card.py`` (the
suite's conftest imports JAX, which the card's machine lacks)."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import numpy as np
import pytest
import torch

import partition_cases as cases

from locust_tpu_torch import obs
from locust_tpu_torch.ops.kernels.partition import stable_partition


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partition kernel runs there")
    return torch.device("cuda")


# name: (rows, bins, capacity, leftover capacity, hot share, payload (shape, dtype) or None)
CASES = {
    "one_bin_records": (1_000_003, 1, 1_000_008, 0, 0.0, ((25,), np.int32)),
    "one_bin_full": (2_048 * 40, 1, 2_048 * 40, 0, 0.0, ((25,), np.int32)),
    "two_bins": (777_777, 2, 400_000, 0, 0.0, None),
    "four_bins_records": (1_000_001, 4, 500_000, 0, 0.0, ((25,), np.int32)),
    "four_bins_spill": (300_001, 4, 60_000, 200_000, 0.5, None),
    "four_bins_overflow": (300_001, 4, 60_000, 50_000, 0.6, None),
    "four_bins_payload_overflow": (300_001, 4, 60_000, 0, 0.6, ((25,), np.int32)),
    "seven_bins_int64_payload": (500_009, 7, 90_000, 0, 0.1, ((3,), np.int64)),
    "seven_bins_spill": (500_009, 7, 60_000, 100_000, 0.3, None),
    "sixty_four_bins_records": (1_234_567, 64, 25_000, 0, 0.2, ((25,), np.int32)),
    "sixty_four_bins_spill": (1_234_567, 64, 18_000, 40_000, 0.2, None),
    "empty": (0, 4, 16, 8, 0.0, None),
    "empty_records": (0, 4, 16, 0, 0.0, ((25,), np.int32)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_partition_equals_the_plain_version(card, case):
    n, n_bins, cap, lcap, hot, payload_of = CASES[case]
    shape, dtype = payload_of if payload_of is not None else (None, np.int32)
    args = cases.batch(n, n_bins, seed=n + n_bins, hot=hot, invalid=0.05, out_of_range=0.01,
                       payload_shape=shape, payload_dtype=dtype)
    want_rows, want_ovf, want_binned, want_totals = stable_partition(*args[:4], n_bins, cap,
                                                                     lcap, args[4])
    before = stable_partition.launches
    rows, overflow, binned, totals = stable_partition(
        *(t.to(card) for t in args[:4]), n_bins, cap, lcap,
        None if args[4] is None else args[4].to(card))
    assert stable_partition.launches == before + 1
    torch.cuda.synchronize()
    assert rows.device.type == "cuda" and torch.equal(rows.cpu(), want_rows)
    assert int(overflow) == int(want_ovf) and torch.equal(totals.cpu(), want_totals)
    if "spill" in case or "overflow" in case:
        assert int(want_ovf) > 0 or bool(want_rows[n_bins * cap:, -1].any())
    if args[4] is None:
        assert binned is None
        return
    assert binned.dtype == args[4].dtype and binned.shape == want_binned.shape
    filled = want_rows[: n_bins * cap, -1].reshape(n_bins, cap) != 0
    assert torch.equal(binned.cpu()[filled], want_binned[filled])


@pytest.mark.cuda
def test_card_counts_one_launch_a_call(card):
    args = [t.to(card) for t in cases.batch(50_000, 4, seed=9)[:4]]
    obs.disable()
    obs.enable(process="unit")
    try:
        before = stable_partition.launches
        for _ in range(3):
            stable_partition(*args, 4, 20_000, 0)
        torch.cuda.synchronize()
        assert stable_partition.launches == before + 3
        assert obs.metrics_snapshot()["counters"]["shuffle.partition_launches"] == 3
    finally:
        obs.disable()
