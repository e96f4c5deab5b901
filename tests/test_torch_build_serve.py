"""PyTorch port, a rehearsal of ``chip_smoke.py``'s serve phase on the CPU at
small shapes, the plain versions counted as launches (split from
tests/test_torch_build.py to keep each file under a minute)."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

from smoke_rig import rehearsal


def test_chip_smoke_serve_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``serve_phase`` end to end at small shapes on the CPU (the daemon
    in process, as processes killed -9 and replayed, under chaos), the
    plain versions counted as launches: its predicted launch counts,
    cache answers and counters hold here as they must on the card."""
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
        serve_big_bytes=200_000, serve_daemon_extra=["--backend", "cpu"],
        serve_submit_extra=["--block-lines", str(bl)])
    report = smoke.serve_phase(env)
    assert report["launches"] == report["expected_launches"] == {
        "tokenize": 0, "bitonic_sort": 4 + 2 + 32 + 2 + 2 + 8, "fused_fold": 4 + 2 + 32 + 2 + 2,
        "pagerank": 0, "partition": 0}
    assert report["process"]["state_at_kill"] == "running"
    assert report["chaos"] == {"poison_job": 1, "deadline_exceeded": 1}
