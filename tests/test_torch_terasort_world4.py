"""PyTorch port, the record sort (``DistributedSort.sort_records``) and the
mesh's split-size all-to-all (``Mesh.all_to_all_v``) across a gloo world
of 4 CPU processes (tests/torch_mesh_rig.py, one world for the module).

The sort of 3,000 records a rank whose keys share 8- and 9-byte prefixes
and repeat exactly on every rank: the ranks' outputs in rank order equal
the plain reference (tests/plain_terasort.py) over the ranks' inputs in
rank order, byte for byte: the global stable order, equal keys
sender-major.  With each rank's tracer on, the exchange has its span and
the mesh counts three all-to-alls a rank (the bins' counts, then the
filled rows of the packed key bins and of the binned records) of the
bytes handed over.  Three more sorts (``rig.TERASORT4_CASES``): a hot
key that overflows its bin on every rank, a rank with no records, and one
key on every record (three ranks receive nothing, the fourth every rank's
ties): each equals the capped-bin rule walked here in Python from the
sort's own splitters (a bin keeps its first ``bin_capacity`` rows in input
order and drops the rest), overflow included, and each rank counts the
slots it did not send in ``sample_sort.slots_skipped``.

``Mesh.all_to_all_v`` of blocks of 0 to 7 rows (a rank that sends one
peer nothing, a rank that sends and receives nothing) returns what arrived
dense and sender-major, along the world's axis and along a 2-D mesh's;
along an axis of one rank it is the identity and counts nothing."""

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


def _got(world, table: str = "terasort4") -> dict:
    if world["got"] is None:
        rig.finish_world(world["procs"], world["out"], "torch")
        world["got"] = {}
        for name in ("terasort4", "terasort4_cases", "a2av"):
            with np.load(f"{world['out']}/{name}.npz") as z:
                world["got"][name] = {k: z[k] for k in z.files}
    return world["got"][table]


def _inputs() -> torch.Tensor:
    return torch.from_numpy(np.concatenate([rig.terasort_input("planted", N, r)
                                            for r in range(RANKS)]))


def _capped_bins(inputs: list, splitters: np.ndarray, cap: int):
    """The range shuffle walked row by row: each rank's records into the
    bins of the splitters (``#splitters <= key``, keys zero-padded to 12
    bytes, big-endian lanes), a bin keeping its first ``cap`` rows in
    input order; each destination's kept rows sender-major, stably sorted
    by key.  Returns each rank's expected output, the overflow and the
    rows each rank sends."""
    split = [row.view(np.uint32).astype(">u4").tobytes() for row in splitters]
    kept = [[] for _ in range(RANKS)]
    overflow, sent = 0, []
    for records in inputs:
        bins = [[] for _ in range(RANKS)]
        for row in records:
            key = bytes(row[:KEY]) + bytes(12 - KEY)
            bins[sum(s <= key for s in split)].append(row)
        for d, rows in enumerate(bins):
            kept[d].extend(rows[:cap])
            overflow += max(0, len(rows) - cap)
        sent.append(sum(min(len(rows), cap) for rows in bins))
    outs = [np.array(sorted(rows, key=lambda row: bytes(row[:KEY])), np.uint8).reshape(-1, 100)
            for rows in kept]
    return outs, overflow, sent


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
    lanes = 12 // 4
    # Every rank's N rows fill its bins' prefixes (none overflows): each
    # row's packed key (lanes, value and a valid word, int32) and its
    # record (25 int32 words) are handed over, and the bins' int32 counts
    # before them.  The bins' empty slots stay behind.
    assert int(got["overflow"]) == 0
    sent = N * (lanes + 2) * 4 + N * rig.RECORD_BYTES + RANKS * 4
    assert got["a2a_calls"].tolist() == [3] * RANKS
    assert got["a2a_bytes"].tolist() == [sent] * RANKS
    for names in got["spans"]:
        assert str(names).split(",") == ["sample_sort.sample", "sample_sort.partition",
                                         "sample_sort.exchange", "sample_sort.partition",
                                         "sample_sort.local", "sample_sort.records"]


@pytest.mark.parametrize("case", sorted(rig.TERASORT4_CASES))
def test_sort_cases_keep_the_capped_bins_rows(world, case):
    got = _got(world, "terasort4_cases")
    kind, counts, rows_per_device, skew = rig.TERASORT4_CASES[case]
    cap = int(got[f"{case}_cap"])
    assert cap == min(sized_bins(rows_per_device, RANKS, skew), -(-rows_per_device // 8) * 8)
    inputs = [rig.terasort_input(kind, n, r) for r, n in enumerate(counts)]
    outs, overflow, sent = _capped_bins(inputs, got[f"{case}_splitters"], cap)
    assert int(got[f"{case}_overflow"]) == overflow
    assert got[f"{case}_counts"].tolist() == [o.shape[0] for o in outs]
    assert np.array_equal(got[f"{case}_records"], np.concatenate(outs))
    skipped, syncs, calls, handed = got[f"{case}_counters"].T
    assert skipped.tolist() == [RANKS * cap - n for n in sent]
    assert handed.tolist() == [n * (5 * 4 + rig.RECORD_BYTES) + RANKS * 4 for n in sent]
    assert calls.tolist() == [3] * RANKS and syncs.tolist() == [4] * RANKS
    if case == "skewed":
        assert overflow > 0  # the hot key's bin overflows
    else:
        assert overflow == 0 and torch.equal(
            torch.from_numpy(got[f"{case}_records"]),
            plain.terasort(torch.from_numpy(np.concatenate(inputs)), KEY))
    if case == "one_key":
        # Ranks 0-2 receive nothing; rank 3 every record, sender-major.
        assert got[f"{case}_counts"].tolist() == [0, 0, 0, sum(counts)]
        number = [int.from_bytes(bytes(row[12:20]), "big") for row in got[f"{case}_records"]]
        assert number == [i for n in counts for i in range(n)]


def test_all_to_all_v_is_dense_and_sender_major(world):
    got = _got(world, "a2av")
    want = [np.concatenate([rig.a2av_block(s, d) for s in range(RANKS)]) for d in range(RANKS)]
    assert got["counts"].tolist() == [w.shape[0] for w in want] == [6, 0, 12, 11]
    assert np.array_equal(got["got"], np.concatenate(want))
    assert got["along_counts"].tolist() == got["counts"].tolist()
    assert np.array_equal(got["along"], got["got"])
    assert got["identity"].tolist() == [True] * RANKS
    # One call each along the axes of 4 ranks, of the rows handed over
    # (this rank's own included, 12 bytes a row); none along the axis of one.
    handed = [sum(rig.A2AV_SIZES[r]) * 12 for r in range(RANKS)]
    for r in range(RANKS):
        assert got["counters"][r].tolist() == [[1, handed[r]], [2, 2 * handed[r]],
                                               [2, 2 * handed[r]]]
