"""PyTorch port, the record sort (``DistributedSort.sort_records``) against
the plain reference (tests/plain_terasort.py), byte for byte: 100-byte
records by a 10-byte key, on a world of one in this process and on a gloo
world of 2 CPU processes (tests/torch_mesh_rig.py), where the ranks'
outputs in rank order are the global order.  Inputs: uniform printable
keys, keys sharing 8- and 9-byte prefixes with exact duplicates (input
order kept), keys over every byte value (unsigned order), a mostly
padded input.  Also ``sort_records`` against ``sort_rows``' order, the
refusals, the spans and counters, and one ``cuda`` case at 2^20 records
that holds the card's output to the reference (on the card: ``python -m
pytest --noconftest tests/test_torch_terasort.py``)."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import numpy as np
import pytest
import torch

import plain_terasort as plain
import torch_mesh_rig as rig

from locust_tpu_torch import obs
from locust_tpu_torch.apps.sample_sort import DistributedSort
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.parallel import make_mesh
from locust_tpu_torch.parallel import mesh as mesh_mod

CFG = EngineConfig(key_width=12)
KEY = rig.KEY_BYTES


@pytest.fixture
def world():
    """A world of one rank in this process (gloo), left after the test."""
    mesh_mod.shutdown()
    mesh = make_mesh(device="cpu")
    yield mesh
    mesh_mod.shutdown()


@pytest.fixture
def telemetry():
    obs.disable()
    yield
    obs.disable()


def _sort(mesh, records, rows_per_device=None, key_bytes=KEY):
    n = records.shape[0]
    return DistributedSort(mesh, CFG, rows_per_device or n).sort_records(records, key_bytes)


@pytest.mark.parametrize("kind", sorted(rig.TERASORT))
def test_world_of_one_equals_the_reference(world, kind):
    n, rows_per_device = rig.TERASORT[kind]
    records = torch.from_numpy(rig.terasort_input(kind, 4 * n, 11))
    got, overflow = _sort(world, records, 4 * rows_per_device)
    assert overflow == 0 and got.dtype == torch.uint8 and got.device == records.device
    assert torch.equal(got, plain.terasort(records, KEY))


def test_equal_keys_keep_their_input_order(world):
    records = torch.from_numpy(rig.terasort_input("planted", 2000, 5))
    got, _ = _sort(world, records)
    keys = [bytes(r[:KEY].tolist()) for r in got]
    number = got[:, 12:20].numpy().copy().view(">u8").ravel()
    runs = [number[[i for i, k in enumerate(keys) if k == dup]]
            for dup in (b"duplicate0", b"duplicate1", b"TeraSort!!")]
    assert all(len(r) > 100 and np.all(np.diff(r.astype(np.int64)) > 0) for r in runs)
    # The planted prefixes: 8- and 9-byte runs in key order.
    assert keys == sorted(keys)
    assert sum(k.startswith(b"TeraSort") for k in keys) > 1000


def test_unsigned_byte_order(world):
    records = torch.from_numpy(rig.terasort_input("binary", 3000, 2))
    got, _ = _sort(world, records)
    keys = [bytes(r[:KEY].tolist()) for r in got]
    assert keys == sorted(keys) and keys[0][0] < 0x80 <= keys[-1][0]


def test_mostly_padded_input_and_a_shorter_key(world):
    records = torch.from_numpy(rig.terasort_input("gensort", 37, 3))
    got, overflow = _sort(world, records.numpy(), rows_per_device=4096)
    assert overflow == 0 and torch.equal(got, plain.terasort(records, KEY))
    got8, _ = _sort(world, records, key_bytes=8)
    assert torch.equal(got8, plain.terasort(records, 8))
    empty, _ = _sort(world, records[:0], rows_per_device=64)
    assert empty.shape == (0, rig.RECORD_BYTES)


def test_sort_records_and_sort_rows_give_one_order(world):
    records = torch.from_numpy(rig.terasort_input("planted", 1500, 9))
    n = records.shape[0]
    got, _ = _sort(world, records)
    keys = np.zeros((n, CFG.key_width), np.uint8)
    keys[:, :KEY] = records[:, :KEY].numpy()
    res = DistributedSort(world, CFG, n).sort_rows(keys)
    order = [v for _, v in res.to_host_sorted()]
    assert res.overflow == 0 and torch.equal(got, records[order])


def test_refusals(world):
    records = torch.zeros((8, 16), dtype=torch.uint8)
    ds = DistributedSort(world, CFG, 8)
    for bad in (0, 13):
        with pytest.raises(ValueError, match="key_bytes"):
            ds.sort_records(records, bad)
    with pytest.raises(ValueError, match="key_bytes"):
        ds.sort_records(records[:, :6], 8)  # the key is past the record
    with pytest.raises(ValueError, match="uint8"):
        ds.sort_records(records.int(), 4)
    with pytest.raises(ValueError, match="rows_per_device"):
        DistributedSort(world, CFG, 4).sort_records(records, 4)
    huge = torch.zeros((1, 1), dtype=torch.uint8).expand(2**31, 1)  # no memory behind it
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ds.sort_records(huge, 1)


def test_spans_and_counters(world, telemetry):
    records = torch.from_numpy(rig.terasort_input("gensort", 500, 4))
    _sort(world, records)
    assert obs.metrics_snapshot() == {}  # the tracer off: nothing recorded
    tracer = obs.enable(process="unit")
    _sort(world, records, rows_per_device=512)
    names = [s[0] for s in tracer.spans()]
    assert names == ["sample_sort.sample", "sample_sort.partition", "sample_sort.exchange",
                     "sample_sort.partition", "sample_sort.local", "sample_sort.records"]
    counters = obs.metrics_snapshot()["counters"]
    # The splitters' two count reads, then the overflow and the output's rows in one.
    assert counters == {"sample_sort.rows": 500, "sample_sort.host_syncs": 3}
    from locust_tpu_torch.apps.sample_sort import sort_strings

    # 80 rows in bins of 24 overflow at skew factors 0.25 and 0.5, so two
    # retries; 80 valid rows sorted by each of the three attempts.
    assert sort_strings([b"b", b"a"] * 40, world, skew_factor=0.25) == [b"a"] * 40 + [b"b"] * 40
    counters = obs.metrics_snapshot()["counters"]
    assert counters["sample_sort.retries"] == 2 and counters["sample_sort.rows"] == 500 + 3 * 80


@pytest.fixture(scope="module")
def world_of_two(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("terasort_world"))
    procs = rig.start_world("torch", 2, out, "apps_terasort")
    state = {"procs": procs, "out": out, "done": False}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("kind", sorted(rig.TERASORT))
def test_world_of_two_in_rank_order_equals_the_reference(world_of_two, kind):
    if not world_of_two["done"]:
        rig.finish_world(world_of_two["procs"], world_of_two["out"], "torch")
        world_of_two["done"] = True
    got = np.load(f"{world_of_two['out']}/terasort_{kind}.npz")
    n = rig.TERASORT[kind][0]
    records = torch.from_numpy(np.concatenate([rig.terasort_input(kind, n, r) for r in (0, 1)]))
    assert int(got["overflow"]) == 0 and int(got["counts"].sum()) == 2 * n
    assert torch.equal(torch.from_numpy(got["records"]), plain.terasort(records, KEY))
    if kind != "padded":  # both ranks hold a range
        assert got["counts"].min() > 0


@pytest.mark.cuda
def test_card_sorts_two_to_the_twenty_records_as_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the record sort's main path runs there")
    mesh_mod.shutdown()
    try:
        mesh = make_mesh(device="cuda")
        n = 1 << 20
        host = rig.terasort_input("planted", n, 2**31 + 7)
        records = torch.from_numpy(host).to(mesh.device)
        got, overflow = _sort(mesh, records)
        assert overflow == 0 and got.device == records.device
        want = plain.terasort(torch.from_numpy(host), KEY)
        assert torch.equal(got.cpu(), want)
    finally:
        mesh_mod.shutdown()
