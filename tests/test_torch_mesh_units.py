"""PyTorch port, the mesh tier's single-process parts against the JAX
package on the same numpy inputs: ``partition_to_bins`` (each bin's rows,
the spill into the leftover buffer and the overflow), the mesh's local
combiner ``combine_or_passthrough`` (both branches), ``sized_bins``,
``merge_stats_vectors`` and ``RoundStats``, ``checkpoint_digest``, the
engines' checkpoint identities, ``fused_mesh_eligible``; then, in a world
of one rank in this process (gloo on the CPU): sharded checkpoints
resumed across packages against JAX's ``make_mesh(1)`` both ways, kernel
C's mesh caller run through its plain version (the CPU gate demotes it,
as JAX's does), and the mesh's refusals."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import py_wordcount

from locust_tpu import parallel as jparallel
from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.core import bytes_ops as jbytes
from locust_tpu.core.kv import KVBatch as JKV
from locust_tpu.ops import hash_table as jht
from locust_tpu.ops.map_stage import wordcount_map as jmap
from locust_tpu.parallel import shuffle as jshuffle
from locust_tpu.parallel.hierarchical import HierarchicalMapReduce as JHier
from locust_tpu_torch import parallel as tparallel
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.core import bytes_ops as tbytes
from locust_tpu_torch.core.kv import KVBatch as TKV
from locust_tpu_torch.ops import hash_table as tht
from locust_tpu_torch.ops.kernels import fused_fold as tfused
from locust_tpu_torch.ops.map_stage import wordcount_map as tmap
from locust_tpu_torch.parallel import mesh as tmesh
from locust_tpu_torch.parallel import shuffle as tshuffle
from locust_tpu_torch.parallel.hierarchical import HierarchicalMapReduce as THier


def _batch(words, values=None, valid=None, width=32):
    keys = jbytes.strings_to_rows(words, width)
    n = len(words)
    values = np.arange(n, dtype=np.int32) if values is None else np.asarray(values, np.int32)
    valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    j = JKV.from_bytes(jnp.asarray(keys), jnp.asarray(values), jnp.asarray(valid))
    t = TKV.from_bytes(torch.from_numpy(keys), torch.from_numpy(values), torch.from_numpy(valid))
    return j, t


def _rows_by_bin(lanes, values, valid):
    """Each bin's live rows as a sorted list of (lanes, value)."""
    lanes, values, valid = (np.asarray(x) for x in (lanes, values, valid))
    lanes = lanes.view(np.uint32) if lanes.dtype == np.int32 else lanes
    return [sorted((tuple(lanes[b, i].tolist()), int(values[b, i]))
                   for i in np.flatnonzero(valid[b])) for b in range(valid.shape[0])]


def _live(kv):
    lanes = np.asarray(kv.key_lanes)
    lanes = lanes.view(np.uint32) if lanes.dtype == np.int32 else lanes
    return sorted((tuple(lanes[i].tolist()), int(np.asarray(kv.values)[i]))
                  for i in np.flatnonzero(np.asarray(kv.valid)))


CASES = {
    "routes": ([b"w%d" % i for i in range(50)], None, 4, 32, 0),
    "overflow": ([b"same"] * 20, None, 4, 8, 0),
    "spill": ([b"same"] * 20, None, 4, 8, 16),
    "leftover_overflow": ([b"same"] * 20, None, 4, 8, 5),
    "invalid_and_skew": ([b"k%d" % (i % 37) for i in range(600)],
                         np.arange(600) % 5 != 0, 3, 40, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_to_bins_equals_jax(case):
    words, valid, n_bins, cap, lcap = CASES[case]
    jb, tb = _batch(words, valid=valid)
    j = jshuffle.partition_to_bins(jb, n_bins, cap, leftover_capacity=lcap)
    t = tshuffle.partition_to_bins(tb, n_bins, cap, leftover_capacity=lcap)
    assert t[0].shape == (n_bins, cap, 8) and t[0].dtype == torch.int32
    # The bins hold the same rows (each package orders a bin its own way:
    # the port by a stable sort, JAX by an unstable one), the overflow and
    # the leftover's rows and size are the same.
    assert _rows_by_bin(*t[:3]) == _rows_by_bin(*j[:3])
    assert int(t[3]) == int(j[3])
    assert t[4].size == j[4].size == lcap
    assert int(t[4].valid.sum()) == int(np.asarray(j[4].valid).sum())
    if case != "invalid_and_skew":  # one key: which rows spill is the same
        assert _live(t[4]) == _live(j[4])
    # Within a bin the port keeps the rows' input order.
    for b in range(n_bins):
        vals = t[1][b][t[2][b]].tolist()
        assert vals == sorted(vals)


@pytest.mark.parametrize("n_distinct,n", [(5, 400), (900, 1000), (2000, 2048)])
def test_combine_or_passthrough_equals_jax(n_distinct, n):
    rng = np.random.default_rng(n_distinct)
    words = [b"key%05d" % i for i in rng.integers(0, n_distinct, n)]
    valid = rng.random(n) < 0.9
    jb, tb = _batch(words, values=rng.integers(1, 5, n), valid=valid)
    j = jht.combine_or_passthrough(jb, "sum", probes=2)
    t = tht.combine_or_passthrough(tb, "sum", probes=2)
    assert np.array_equal(t.key_lanes.numpy().view(np.uint32), np.asarray(j.key_lanes))
    assert np.array_equal(t.values.numpy(), np.asarray(j.values))
    assert np.array_equal(t.valid.numpy(), np.asarray(j.valid))
    # Either way the rows re-reduce to the batch's totals.
    assert dict(tht.aggregate_exact(t, 4096)[0].to_host_pairs()) == dict(
        tht.aggregate_exact(tb, 4096)[0].to_host_pairs())


def test_combine_or_passthrough_refuses_count():
    _, tb = _batch([b"a", b"b"])
    with pytest.raises(ValueError, match="count"):
        tht.combine_or_passthrough(tb, "count")


@pytest.mark.parametrize("args", [(81920, 1, 2.0), (81920, 2, 2.0), (512, 8, 0.1),
                                  (1, 4, 1.0), (65536, 3, 1.5)])
def test_sized_bins_equals_jax(args):
    assert tshuffle.sized_bins(*args) == jshuffle.sized_bins(*args)


def test_round_stats_and_merge_equal_jax():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 100, (7, 2, 6)).astype(np.int32)
    for stack in (rows[:, 0], rows.reshape(7, 12)):
        synced_t, synced_j = [], []
        rt = tshuffle.RoundStats(tshuffle.merge_stats_vectors, synced_t.append, every=3)
        rj = jshuffle.RoundStats(jshuffle.merge_stats_vectors, synced_j.append, every=3)
        for r in stack:
            rt.push(torch.from_numpy(r.copy()))
            rj.push(jnp.asarray(r))
        rt.flush()
        rj.flush()
        assert len(synced_t) == len(synced_j) == 3
        for a, b in zip(synced_t, synced_j):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="stats_sync_every"):
        tshuffle.RoundStats(tshuffle.merge_stats_vectors, print, every=0)


def test_checkpoint_digest_equals_jax():
    rng = np.random.default_rng(1)
    arrays = {"acc_key_lanes": rng.integers(0, 2**32, (16, 8), dtype=np.uint32),
              "acc_valid": rng.random(16) < 0.5, "next_round": np.int64(3),
              "drains_by_slice": np.arange(2, dtype=np.int64), "truncated": np.bool_(False)}
    assert tshuffle.checkpoint_digest(arrays) == jshuffle.checkpoint_digest(arrays)


@pytest.fixture(scope="module")
def world():
    """A world of one rank in this process (gloo), left at the end."""
    mesh = tparallel.make_mesh(device="cpu")
    yield mesh
    tmesh.shutdown()


IDENTITY_CASES = [
    ({}, {}), ({"sort_mode": "hasht", "table_size": 4096}, {"combine": "count"}),
    ({"block_lines": 64}, {"on_overflow": "drop", "bin_capacity": 12}),
    ({"sort_mode": "fused"}, {"shard_capacity": 1000, "skew_factor": 0.5}),
]


@pytest.mark.parametrize("cfg_kw,eng_kw", IDENTITY_CASES)
def test_checkpoint_identities_equal_jax(world, cfg_kw, eng_kw):
    rows = jbytes.strings_to_rows([b"a b c", b"d e"] * 9, 128)
    j = jparallel.DistributedMapReduce(jparallel.make_mesh(1), JConfig(**cfg_kw), **eng_kw)
    t = tparallel.DistributedMapReduce(world, TConfig(**cfg_kw), **eng_kw)
    assert t._identity() == j._identity()
    assert t._fingerprint(rows) == j._fingerprint(rows)
    hier_kw = {k: v for k, v in eng_kw.items() if k != "on_overflow"}
    jh = JHier(jparallel.make_mesh_2d(1, 1), JConfig(**cfg_kw), **hier_kw)
    th = THier(tparallel.make_mesh_2d(1, device="cpu"), TConfig(**cfg_kw), **hier_kw)
    assert th._identity() == jh._identity()
    assert (th.bin_capacity, th.shard_capacity, th.max_drain_rounds) == (
        jh.bin_capacity, jh.shard_capacity, jh.max_drain_rounds)


def test_fused_mesh_eligible(caplog):
    cfg = TConfig(sort_mode="fused")
    assert tfused.fused_mesh_eligible(cfg, tmap, "sum", torch.device("cuda")) == (True, "")
    ok, why = tfused.fused_mesh_eligible(cfg, tmap, "sum", "cpu")
    assert not ok and "CUDA rank" in why and "'hasht'" in why
    small = TConfig(sort_mode="fused", block_lines=64, emits_per_line=8)
    ok, why = tfused.fused_mesh_eligible(small, tmap, "sum", torch.device("cuda"))
    from locust_tpu.ops.pallas.fused_fold import fused_mesh_eligible as jelig

    jok, jwhy = jelig(JConfig(sort_mode="fused", block_lines=64, emits_per_line=8),
                      jmap, "sum")
    assert not ok and not jok and "exceeds the shard's emit capacity (512)" in why
    assert tfused.fused_mesh_eligible(cfg, tmap, "max", "cuda")[1] == \
        tfused.fused_engine_eligible(cfg, tmap, "max")[1]
    with caplog.at_level(logging.INFO, logger="locust_tpu_torch"):
        assert tshuffle._fused_mesh_gate(cfg, tmap, "sum", "flat", "cpu") == (False, True)
    assert "flat mesh sort_mode='fused': kernel not engaged" in caplog.text
    assert tshuffle._fused_mesh_gate(TConfig(), tmap, "sum", "flat", "cpu") == (False, False)


def _crash(eng, rows, ckpt):
    real, calls = eng._step, {"n": 0}

    def crashing(*a):
        if calls["n"] == 2:
            raise RuntimeError("injected crash")
        calls["n"] += 1
        return real(*a)

    eng._step = crashing
    with pytest.raises(RuntimeError, match="injected crash"):
        eng.run(rows, checkpoint_dir=ckpt, checkpoint_every=1, stats_sync_every=1)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("mode", ["hash", "hasht"])
def test_world_of_one_resumes_across_packages(world, tmp_path, writer, mode):
    """A snapshot written by one package at round 2 (``state.p0.npz``)
    is trusted by the other, which folds only the rounds after it."""
    cfg_kw = dict(block_lines=64, line_width=128, emits_per_line=8, sort_mode=mode)
    lines = [b"alpha beta", b"beta gamma", b"alpha delta epsilon"] * 100
    rows = jbytes.strings_to_rows(lines, 128)
    make = {"jax": lambda: jparallel.DistributedMapReduce(jparallel.make_mesh(1),
                                                           JConfig(**cfg_kw)),
            "torch": lambda: tparallel.DistributedMapReduce(world, TConfig(**cfg_kw))}
    reader = "torch" if writer == "jax" else "jax"
    _crash(make[writer](), rows, str(tmp_path))
    assert (tmp_path / "state.p0.npz").exists()
    eng = make[reader]()
    real, steps = eng._step, {"n": 0}

    def counting(*a):
        steps["n"] += 1
        return real(*a)

    eng._step = counting
    res = eng.run(rows, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert steps["n"] == -(-len(lines) // 64) - 2
    assert dict(res.to_host_pairs()) == dict(py_wordcount(lines, 8))


@pytest.mark.parametrize("flagged", [False, True])
def test_fused_mesh_caller_through_the_plain_version(world, monkeypatch, flagged):
    """Kernel C's mesh caller, forced on in a CPU world: each round's
    plain pre-aggregation (or, when its flag is set, the stock map and
    ``combine_or_passthrough``) feeds the shuffle; the table equals the
    hasht engine's, and the overflow is the kernel's."""
    # 160 emits a line: the kernel's 8,192 table and 64 residual rows fit
    # a 64-line block's 10,240 emits, as the eligibility rule demands.
    cfg = TConfig(sort_mode="fused", block_lines=64, line_width=128, emits_per_line=160)
    lines = [b" ".join(b"w%d" % ((7 * i + j) % 300) for j in range(9)) for i in range(700)]
    rows = tbytes.strings_to_rows(lines, 128)
    calls = {"n": 0}
    real = tfused.fused_block_preagg

    def preagg(x, c):
        calls["n"] += 1
        tab, res, ovf, flag = real(x, c)
        return tab, res, ovf, torch.tensor(flagged) | flag

    monkeypatch.setattr(tfused, "fused_block_preagg", preagg)
    eng = tparallel.DistributedMapReduce(world, cfg)
    assert eng.fused_demoted and eng._step.fused_preagg is False
    eng._step.fused_preagg = True
    res = eng.run(rows)
    want = tparallel.DistributedMapReduce(world, dataclasses.replace(cfg, sort_mode="hasht"))
    wres = want.run(rows)
    assert calls["n"] == -(-len(lines) // 64)
    assert res.to_host_pairs() == wres.to_host_pairs() == sorted(py_wordcount(lines).items())
    assert res.emit_overflow == wres.emit_overflow
    assert res.fused_refolds == (calls["n"] if flagged else 0)
    for k in ("key_lanes", "values", "valid"):
        assert np.array_equal(res.gather()[k], wres.gather()[k])


def test_mesh_refusals(world, monkeypatch):
    with pytest.raises(ValueError, match="requested 3 devices, have 1"):
        tparallel.make_mesh(3)
    with pytest.raises(ValueError, match="do not divide into 2 slices"):
        tparallel.make_mesh_2d(2)
    with pytest.raises(ValueError, match="on_overflow"):
        tparallel.DistributedMapReduce(world, TConfig(), on_overflow="keep")
    with pytest.raises(ValueError, match="bin_capacity"):
        tparallel.DistributedMapReduce(world, TConfig(), bin_capacity=0)
    # No world joined and no card: a mesh entry point raises, never runs
    # quietly on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.initialize_multihost("127.0.0.1:1", 1, 0)


@pytest.mark.parametrize("cards, want", [
    (["host-a/GPU-0", "host-b/GPU-0"], "nccl"),  # two hosts, one card each
    (["host-a/GPU-0", "host-a/GPU-1"], "nccl"),  # one host, a card per rank
    (["host-a/GPU-0", "host-a/GPU-0"], "gloo"),  # two ranks share a card
    (["host-a/GPU-0", None], "gloo"),            # a rank on the CPU
])
def test_backend_rule_reads_every_ranks_card(cards, want):
    """Each rank publishes its card in the coordinator's store and reads
    every other rank's, so all of them reach the same backend; ranks on
    two hosts with one card each (both index 0) pick NCCL."""
    import threading

    master = tmesh.coordinator_store(2)
    stores = [master, torch.distributed.TCPStore("127.0.0.1", master.port, 2, False,
                                                 timeout=tmesh.COLLECTIVE_TIMEOUT)]
    got = [None, None]

    def rank(r):
        got[r] = tmesh.pick_backend(tmesh._exchange_cards(stores[r], 2, r, cards[r]))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert got == [want, want]
    assert tmesh.card_identity(torch.device("cpu")) is None
