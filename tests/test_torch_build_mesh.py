"""PyTorch port, a rehearsal of ``chip_smoke.py``'s mesh phase on the CPU
at small shapes, the plain versions counted as launches: ``--mesh`` as a
world of one rank in process, worlds of 2 processes (gloo), a
checkpointed world crashed at a snapshot by a fault plan and resumed,
and ``--slices 2`` over 2 and 4 processes; every stdout the oracle's and
every launch count summed over the processes as the phase predicts."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import functools
import types

import torch

from smoke_rig import rehearsal


def test_chip_smoke_mesh_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    smoke, by_path, run_cli = rehearsal(monkeypatch)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks share the host's cores
    expected = smoke._Expected()
    check_counts = functools.partial(smoke.check_launches, by_path, expected)

    bl = 128
    lines, _ = smoke.replicated_corpus(120_000)
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"\n".join(lines) + b"\n")
    oracle = sorted(smoke.oracle_wordcount(lines, 128, 20, 32).items())
    env = types.SimpleNamespace(
        torch=torch, dev=torch.device("cpu"), lines=lines, BL=bl, work=str(tmp_path),
        corpus_file=str(corpus), want=b"".join(k + b"\t" + str(v).encode() + b"\n"
                                                for k, v in oracle),
        nblocks=-(-len(lines) // bl), run_cli=run_cli, by_path=by_path, expected=expected,
        check_counts=check_counts, smi="cpu", mesh_ckpt_every=2, mesh_crash_gen=4,
        cli_extra=["--backend", "cpu", "--block-lines", str(bl)])
    report = smoke.mesh_phase(env)
    r2 = -(-len(lines) // (2 * bl))
    assert report["w1_fused"]["fused_kernel"] is None and report["w1_fused"]["fused_demoted"]
    assert report["mesh_w2_bitonic"]["launches"] == {
        "tokenize": 2 * r2, "bitonic_sort": 4 * r2, "fused_fold": 0, "pagerank": 0,
        "partition": 2 * r2}
    assert report["mesh_w2_fused"]["launches"]["fused_fold"] == 0  # demoted on the CPU
    assert report["mesh_w2_resumed"]["launches"]["tokenize"] == 2 * (r2 - 2)
    assert report["mesh_hier_2x2"]["axes"] == {"slice": 2, "data": 2}
    assert report["mesh_w2_bitonic"]["all_to_all_calls_per_rank"] == [r2, r2]
