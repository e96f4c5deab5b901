"""PyTorch port, a rehearsal of ``chip_smoke.py``'s pool and failover phase on the CPU at
small shapes, the plain versions counted as launches (split from
tests/test_torch_build.py to keep each file under a minute)."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

from smoke_rig import rehearsal


def test_chip_smoke_pool_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``pool_phase`` end to end on the CPU at 128-line blocks: a daemon
    with ``--workers`` over 2 ``--serve`` worker processes (one-block
    jobs by affinity, a sharded job, tfidf/index/join/PageRank plans, a
    worker killed -9 inside a batch), then the failover pair (the primary
    killed -9, the standby promoted by its lease, the old epoch fenced).
    Every process counts its kernels' plain versions as launches, so the
    predicted launch counts hold here as they must on the card."""
    import types

    import torch

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # its processes share the host's cores
    smoke, by_path, run_cli = rehearsal(monkeypatch)
    bl = 128
    lines, _ = smoke.replicated_corpus(1 << 20)
    env = types.SimpleNamespace(
        torch=torch, dev=torch.device("cpu"), lines=lines, BL=bl, W=128, E=20, K=32,
        work=str(tmp_path), run_cli=run_cli, counted=smoke.counted, by_path=by_path, smi="cpu",
        cli_extra=["--backend", "cpu", "--block-lines", str(bl)], serve_cfg={"block_lines": bl},
        serve_big_bytes=60_000, serve_daemon_extra=["--backend", "cpu"],
        serve_submit_extra=["--block-lines", str(bl)], pool_lease_s=4.0,
        pool_shard_min_blocks=4)
    report = smoke.pool_phase(env)
    # 2 one-block jobs, the big job's 2 shards of 4 and their merge, the
    # tf folds of tfidf and index (2 splits of 2 blocks each), the killed
    # worker's job; the fused jobs and the join's 2 splits, twice; one
    # PageRank gather-add per rank shard and epoch (2 shards, 3 epochs).
    assert report["launches"] == report["expected_launches"] == {
        "tokenize": 0, "bitonic_sort": 2 + 4 + 4 + 1 + 2 * 4 + 1, "fused_fold": 2 + 2 * 4,
        "pagerank": 2 * 3, "partition": 0}
    assert [a["cache"] for a in report["one_block_jobs"]] == ["cold", "warm"] * 2
    assert report["plans"]["join_repeat"]["worker_compiles"] == [0, 0]
    assert report["plans"]["pagerank"]["max_abs_delta_vs_solo"] == 0.0
    fo = report["failover"]
    assert fo["launches"] == fo["expected_launches"] and fo["old_epoch_ship"] == "stale_epoch"
    assert fo["epoch"] == 2
