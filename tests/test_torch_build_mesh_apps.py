"""PyTorch port, a rehearsal of ``chip_smoke.py``'s mesh apps phase on the
CPU at small shapes, the plain versions counted as launches:
``pagerank --mesh`` in worlds of 1 (in process), 2 and 4 (processes),
each against the same world's ``--backend cpu`` stdout, with two
gather-adds per rank and iteration; the gather-add at a world of 2's two
index spaces against the CSR walk; ``index --mesh`` in worlds of 1 and 2
against the oracle; the compiled mesh WordCount plan under ``bitonic``
and ``hasht``; and the sample sort in worlds of 1 and 2 against numpy's
lexsort, with one retry of ``sort_strings``; the partition's plain
version counted once per rank and shuffle round."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import dataclasses
import functools
import os
import types

import numpy as np
import torch

from smoke_rig import rehearsal


def test_chip_smoke_mesh_apps_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    smoke, by_path, run_cli = rehearsal(monkeypatch)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks share the host's cores
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.core import bytes_ops

    expected = smoke._Expected()
    bl = 128
    lines, _ = smoke.replicated_corpus(60_000)
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"\n".join(lines) + b"\n")
    oracle = sorted(smoke.oracle_wordcount(lines, 128, 20, 32).items())
    rng = np.random.default_rng(3)
    n, e = 3000, 20_000
    src, dst = rng.integers(0, n, e), rng.zipf(1.4, e) % n
    src[src % 9 == 0] = 4
    edges = tmp_path / "edges.txt"
    edges.write_text("".join(f"{a}\t{b}\n" for a, b in zip(src, dst)))
    env = types.SimpleNamespace(
        torch=torch, dev=torch.device("cpu"), lines=lines, BL=bl, work=str(tmp_path),
        corpus_file=str(corpus), want=b"".join(k + b"\t" + str(v).encode() + b"\n"
                                                for k, v in oracle),
        cfg=dataclasses.replace(EngineConfig(sort_mode="bitonic", use_pallas=True),
                                block_lines=bl),
        rows=bytes_ops.strings_to_rows(lines, 128), run_cli=run_cli, by_path=by_path,
        expected=expected, check_counts=functools.partial(smoke.check_launches, by_path,
                                                          expected),
        smi="cpu", cli_extra=["--backend", "cpu", "--block-lines", str(bl)],
        pagerank_graph=(n, src, dst, str(edges), smoke.pagerank_oracle(src, dst, n, 20, 0.85)),
        sort_rows=5_000)
    report = smoke.mesh_apps_phase(env)
    for w in (1, 2, 4):
        assert report["pagerank"][f"w{w}"]["launches"]["pagerank"] == 40 * w
    assert report["pagerank"]["distributed_w1"]["launches"]["pagerank"] == 20
    shapes = report["pagerank"]["gather_add_world2"]
    assert shapes["send"]["rows"] != shapes["send"]["sources"]
    assert shapes["send"]["weighted"] and not shapes["receive"]["weighted"]
    assert report["index"]["w2"]["launches"]["tokenize"] == 2 * -(-len(lines) // (2 * bl))
    assert report["index"]["w2"]["launches"]["partition"] == (
        2 * -(-len(lines) // (2 * bl)) + report["index"]["w2"]["drain_rounds"])
    assert report["sort"]["w2"]["launches"]["partition"] == 2 * (1 + 2)  # sort_rows, 2 attempts
    assert report["plan"]["hasht"]["fused_demoted"]  # a CPU rank demotes fused
    assert report["sort"]["w2"]["attempt_overflows"][1] == 0
    assert os.path.exists(tmp_path / "mesh_apps" / "sorted.npz")
