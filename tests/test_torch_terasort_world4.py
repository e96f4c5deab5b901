"""PyTorch port, the record sort (``DistributedSort.sort_records``) across a
gloo world of 4 CPU processes (tests/torch_mesh_rig.py, one world for the
module): 3,000 records a rank whose keys share 8- and 9-byte prefixes and
repeat exactly on every rank.  The ranks' outputs in rank order equal the
plain reference (tests/plain_terasort.py) over the ranks' inputs in rank
order, byte for byte: the global stable order, equal keys sender-major.
With each rank's tracer on, the exchange has its span and the mesh counts
two all-to-alls a rank, of the send buffers' bytes: the packed key bins
and the binned records."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import numpy as np
import pytest
import torch

import plain_terasort as plain
import torch_mesh_rig as rig

from locust_tpu_torch.parallel.shuffle import sized_bins

KEY = rig.KEY_BYTES
N, ROWS_PER_DEVICE = rig.TERASORT4
RANKS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("terasort_world4"))
    procs = rig.start_world("torch", RANKS, out, "apps_terasort4")
    state = {"procs": procs, "out": out, "got": None}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _got(world) -> dict:
    if world["got"] is None:
        rig.finish_world(world["procs"], world["out"], "torch")
        with np.load(f"{world['out']}/terasort4.npz") as z:
            world["got"] = {k: z[k] for k in z.files}
    return world["got"]


def _inputs() -> torch.Tensor:
    return torch.from_numpy(np.concatenate([rig.terasort_input("planted", N, r)
                                            for r in range(RANKS)]))


def test_ranks_in_rank_order_equal_the_reference(world):
    got = _got(world)
    assert int(got["overflow"]) == 0 and int(got["counts"].sum()) == RANKS * N
    assert got["counts"].min() > 0  # every rank holds a range
    assert torch.equal(torch.from_numpy(got["records"]), plain.terasort(_inputs(), KEY))


def test_duplicate_keys_span_ranks_and_stay_sender_major(world):
    records = _got(world)["records"]
    inputs = _inputs().numpy()
    # Each input row's (sender, number): the record number sits in bytes 12-19.
    sender = {bytes(row): r for r in range(RANKS) for row in inputs[r * N:(r + 1) * N]}
    for dup in (b"duplicate0", b"duplicate1", b"TeraSort!!"):
        run = [row for row in records if bytes(row[:KEY]) == dup]
        senders = [sender[bytes(row)] for row in run]
        number = [int.from_bytes(bytes(row[12:20]), "big") for row in run]
        assert len(set(senders)) == RANKS and senders == sorted(senders)
        assert all(a < b for s, a, t, b in zip(senders, number, senders[1:], number[1:])
                   if s == t)


def test_exchange_span_and_counters_count_the_send_buffers(world):
    got = _got(world)
    cap = min(sized_bins(ROWS_PER_DEVICE, RANKS, 2.0), ROWS_PER_DEVICE)
    lanes = 12 // 4
    # The key bins: lanes, value and a valid word, int32; the records: 25
    # int32 words each.  Both [RANKS, cap, ...], on every rank.
    sent = RANKS * cap * (lanes + 2) * 4 + RANKS * cap * rig.RECORD_BYTES
    assert got["a2a_calls"].tolist() == [2] * RANKS
    assert got["a2a_bytes"].tolist() == [sent] * RANKS
    for names in got["spans"]:
        assert str(names).split(",") == ["sample_sort.sample", "sample_sort.partition",
                                         "sample_sort.exchange", "sample_sort.partition",
                                         "sample_sort.local", "sample_sort.records"]
