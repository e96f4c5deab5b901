"""PyTorch port, the shuffle's stable counting partition on the CPU
(``ops/kernels/partition.stable_partition``'s plain version, the
``parallel/shuffle`` functions over it): slot for slot against the
partition walked row by row in Python, at 1, 2, 4, 7 and 64 bins, with
bins that spill into the leftover and past it, invalid rows and buckets
out of range, each bin's total; the filled counts of bins at, under and
over capacity (on a card too, where there is one); ``partition_to_bins``
as views of the packed bins;
``exchange_bins`` on the packed bins against the three tensors packed by
hand; the wrapper's refusals; and the launch counter's registration.
The kernel against this plain version on a card:
``tests/test_torch_partition_card.py``."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import numpy as np
import pytest
import torch

import partition_cases as cases

from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.obs import names
from locust_tpu_torch.ops.kernels import partition
from locust_tpu_torch.parallel import make_mesh
from locust_tpu_torch.parallel import mesh as mesh_mod
from locust_tpu_torch.parallel import shuffle

# name: (rows, bins, capacity, leftover capacity, hot share, payload words)
CASES = {
    "one_bin": (3001, 1, 3008, 0, 0.0, 25),
    "two_bins": (2500, 2, 1400, 0, 0.0, None),
    "four_bins_spill": (2049, 4, 400, 600, 0.5, None),
    "four_bins_overflow": (2047, 4, 300, 100, 0.6, None),
    "four_bins_payload_overflow": (2100, 4, 300, 0, 0.6, 25),
    "seven_bins": (4099, 7, 700, 64, 0.2, None),
    "sixty_four_bins": (6000, 64, 80, 0, 0.3, 25),
    "sixty_four_bins_spill": (6000, 64, 80, 200, 0.3, None),
    "empty_records": (0, 4, 16, 0, 0.0, 25),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_partition_equals_the_row_by_row_walk(case):
    n, n_bins, cap, lcap, hot, words = CASES[case]
    bucket, valid, lanes, values, payload = cases.batch(
        n, n_bins, seed=n, hot=hot, out_of_range=0.02,
        payload_shape=None if words is None else (words,))
    want_rows, want_ovf, want_binned, want_totals = cases.slots_by_hand(
        bucket, valid, lanes, values, n_bins, cap, lcap, payload)
    rows, overflow, binned, totals = partition.stable_partition(bucket, valid, lanes, values,
                                                                n_bins, cap, lcap, payload)
    assert rows.dtype == torch.int32 and np.array_equal(rows.numpy(), want_rows)
    assert overflow.dtype == torch.int32 and int(overflow) == want_ovf
    assert totals.dtype == torch.int32 and totals.tolist() == want_totals
    assert (binned is None) == (payload is None)
    if binned is not None:
        assert np.array_equal(binned.numpy(), want_binned)
    if "spill" in case or "overflow" in case:
        assert want_ovf > 0 or want_rows[n_bins * cap:, -1].any()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_filled_counts_at_under_and_over_capacity(device):
    """Each bin's total from ``stable_partition`` and its filled slots from
    ``partition_packed(filled=True)``: on the CPU against the walk by hand,
    on a card the kernel's against the plain version's; the filled slots
    are each bin's first, the rest empty."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partition kernel runs there")
    cap = 3000
    (bucket, valid, lanes, values), want_totals = cases.bins_at_under_and_over(cap, seed=11)
    want = cases.slots_by_hand(bucket, valid, lanes, values, 4, cap, 0)
    assert want[3] == want_totals
    plain = partition.stable_partition(bucket, valid, lanes, values, 4, cap)
    assert plain[3].tolist() == want_totals
    dev = torch.device(device)
    args = [t.to(dev) for t in (bucket, valid, lanes, values)]
    rows, overflow, binned, totals = partition.stable_partition(*args, 4, cap)
    assert binned is None and totals.device.type == device and totals.dtype == torch.int32
    assert totals.tolist() == want_totals and int(overflow) == cap + 17
    assert torch.equal(rows.cpu(), plain[0])
    bins, overflow2, _, _, filled = shuffle.partition_packed(
        KVBatch(args[2], args[3], args[1]), 4, cap, bucket=args[0], filled=True)
    assert filled.dtype == torch.int32 and filled.tolist() == [cap, cap // 3, cap, 0]
    assert int(overflow2) == cap + 17
    valid_word = bins[..., -1].cpu() != 0
    for b, f in enumerate(filled.tolist()):
        assert bool(valid_word[b, :f].all()) and not bool(valid_word[b, f:].any())
    assert len(shuffle.partition_packed(KVBatch(args[2], args[3], args[1]), 4, cap,
                                        bucket=args[0])) == 4


def test_partition_to_bins_views_the_packed_bins():
    bucket, valid, lanes, values, _ = cases.batch(1000, 4, seed=3, hot=0.5)
    kv = KVBatch(lanes, values, valid)
    bins, overflow, left, _ = shuffle.partition_packed(kv, 4, 200, bucket=bucket,
                                                       leftover_capacity=50)
    l, v, ok, overflow2, left2 = shuffle.partition_to_bins(kv, 4, 200, bucket=bucket,
                                                           leftover_capacity=50)
    assert torch.equal(l, bins[..., :3]) and torch.equal(v, bins[..., 3])
    assert torch.equal(ok, bins[..., 4] != 0) and int(overflow) == int(overflow2) > 0
    for a, b in zip(left.tensors(), left2.tensors()):
        assert torch.equal(a, b)
    assert left.size == 50 and bool(left.valid.all())


@pytest.fixture
def world():
    mesh_mod.shutdown()
    yield make_mesh(device="cpu")
    mesh_mod.shutdown()


def test_exchange_bins_on_the_packed_bins_gives_the_three_tensor_exchange(world):
    bucket, valid, lanes, values, _ = cases.batch(900, 1, seed=5)
    kv = KVBatch(lanes, values, valid)
    bins, _, _, _ = shuffle.partition_packed(kv, 1, 1000, bucket=bucket)
    l, v, ok, _, _ = shuffle.partition_to_bins(kv, 1, 1000, bucket=bucket)
    by_hand = world.all_to_all(torch.cat([l, v[..., None], ok[..., None].to(torch.int32)],
                                         dim=-1), "data").reshape(-1, 5)
    got = shuffle.exchange_bins(world, "data", bins)
    assert torch.equal(got.key_lanes, by_hand[:, :3]) and torch.equal(got.values, by_hand[:, 3])
    assert torch.equal(got.valid, by_hand[:, 4] != 0)
    assert int(got.valid.sum()) == int(valid.sum())


def _args(n=64, **change):
    bucket, valid, lanes, values, payload = cases.batch(n, 4, seed=1, payload_shape=(3,))
    args = dict(bucket=bucket, valid=valid, lanes=lanes, values=values, n_bins=4,
                bin_capacity=32, leftover_capacity=0, payload=payload)
    args.update(change)
    return args


REFUSALS = {
    "lanes_dtype": (dict(lanes=torch.zeros((64, 3), dtype=torch.int64)), "lanes must be"),
    "lanes_shape": (dict(lanes=torch.zeros(64, dtype=torch.int32)), "lanes must be"),
    "values_dtype": (dict(values=torch.zeros(64, dtype=torch.int64)), "values must be"),
    "values_rows": (dict(values=torch.zeros(63, dtype=torch.int32)), "values must be"),
    "valid_dtype": (dict(valid=torch.ones(64, dtype=torch.uint8)), "valid must be"),
    "bucket_dtype": (dict(bucket=torch.zeros(64, dtype=torch.int32)), "bucket must be"),
    "lanes_strided": (dict(lanes=torch.zeros((64, 6), dtype=torch.int32)[:, ::2]),
                      "lanes must be contiguous"),
    "bucket_strided": (dict(bucket=torch.zeros(128, dtype=torch.int64)[::2]),
                       "bucket must be contiguous"),
    "no_bins": (dict(n_bins=0), "n_bins 0"),
    "past_the_limit": (dict(n_bins=partition.MAX_BINS + 1), f"n_bins {partition.MAX_BINS + 1}"),
    "capacity": (dict(bin_capacity=-1), "capacities"),
    "slots": (dict(bin_capacity=2**29), "2\\*\\*31"),
    "payload_rows": (dict(payload=torch.zeros((63, 3), dtype=torch.int32)), "payload must be"),
    "payload_strided": (dict(payload=torch.zeros((64, 6), dtype=torch.int32)[:, ::2]),
                        "payload must be contiguous"),
    "payload_with_leftover": (dict(leftover_capacity=8), "leftover_capacity must be 0"),
    "payload_bytes": (dict(payload=torch.zeros((64, 7), dtype=torch.uint8)),
                      "whole 4-byte words"),
    "payload_misaligned": (dict(payload=torch.zeros(64 * 4 + 1, dtype=torch.uint8)[1:]
                                .view(64, 4)), "whole 4-byte words"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_the_wrapper_refuses(case):
    change, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        partition.stable_partition(**_args(**change))


def test_the_launch_counter_is_registered():
    assert names.NAMES["shuffle.partition_launches"] == "counter"
    assert partition.MAX_BINS == 1024
