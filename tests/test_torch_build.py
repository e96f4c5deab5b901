"""PyTorch port, the parts of the CUDA build and of ``chip_smoke.py`` that
the CPU can check: the build is keyed by the sources, a missing CUDA
compiler raises, the smoke script refuses to run without a GPU or without
the package beside it, and its WordCount, index, tf-idf and PageRank
oracles agree with the port on the CPU.  The rehearsals of its serve,
pool and mesh phases have files of their own
(tests/test_torch_build_serve.py, test_torch_build_pool.py,
test_torch_build_mesh.py)."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os
import shutil
import subprocess
import sys

import pytest

from locust_tpu_torch import _build
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.engine import MapReduceEngine
from smoke_rig import SMOKE, smoke_module


def test_library_path_is_keyed_by_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}
    assert len(set(before.values())) == len(before)
    assert all(p.parent == _build.BUILD_DIR for p in before.values())
    # An edit to one source moves only that library; a shared header
    # moves every one.
    with open(csrc / "bitonic.cu", "a") as f:
        f.write("\n")
    assert _build.library_path("bitonic") != before["bitonic"]
    assert _build.library_path("tokenize") == before["tokenize"]
    (csrc / "common.cuh").write_text("#pragma once\n")
    assert _build.library_path("tokenize") != before["tokenize"]


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    real_exists = os.path.exists
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(
        _build.os.path, "exists",
        lambda path: False if str(path).endswith("nvcc") else real_exists(path),
    )
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_gpu_or_the_package(alone, tmp_path):
    """No CUDA here; and a directory holding only the script has no
    package to drive.  Either way: non-zero exit, no result line."""
    script = SMOKE
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.dirname(script), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, script], env=env, cwd=os.path.dirname(script),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "chip_smoke:" in out.stderr


def test_chip_mesh_refuses_without_a_gpu():
    """``chip_mesh.py``, the PageRank and mesh phases alone, exits 1 and
    runs nothing where no card is visible."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.dirname(SMOKE), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, os.path.join(os.path.dirname(SMOKE), "chip_mesh.py")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and out.stdout == ""
    assert "chip_mesh: no CUDA device" in out.stderr


def test_chip_smoke_oracle_equals_the_port_engine():
    """The smoke script's oracle is independent of the code under test;
    on the CPU, at the CLI's widths, both give the same host pairs."""
    smoke = smoke_module()
    lines, nbytes = smoke.replicated_corpus(200_000)
    cfg = EngineConfig(sort_mode="bitonic", use_pallas=True, block_lines=1024)
    assert nbytes >= 200_000 and len(lines) > 2 * cfg.block_lines
    rows = bytes_ops.strings_to_rows(lines, cfg.line_width)
    res = MapReduceEngine(cfg, device="cpu").run_fused(rows)
    oracle = smoke.oracle_wordcount(lines, cfg.line_width, cfg.emits_per_line, cfg.key_width)
    assert res.to_host_pairs() == sorted(oracle.items())
    assert not res.truncated


def test_chip_smoke_bound_names_the_larger_time():
    smoke = smoke_module()
    t, by = smoke.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = smoke.bound_ms(1.0, 67e9)
    assert by == "operations" and t == pytest.approx(1.0)


def test_chip_smoke_app_oracles_equal_the_port(tmp_path, capfdbinary):
    """The smoke script's index/tfidf renderings and its float64 PageRank
    agree with the port's CLI and ``pagerank`` on the CPU (small shapes,
    documents of 7 lines, so that the scores are not all 0)."""
    import numpy as np

    from locust_tpu_torch import cli
    from locust_tpu_torch.apps.pagerank import pagerank

    smoke = smoke_module()
    lines = smoke.replicated_corpus(30_000)[0]
    path = tmp_path / "c.txt"
    path.write_bytes(b"\n".join(lines) + b"\n")
    tf, n_docs = smoke.oracle_docs(lines, 7, 128, 20, 32)
    for app, want in (("index", smoke.render_postings(tf)), ("tfidf", smoke.render_tfidf(tf, n_docs))):
        assert cli.main([app, str(path), "--lines-per-doc", "7", "--block-lines", "256",
                         "--backend", "cpu"]) == 0
        assert capfdbinary.readouterr().out == want
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    src[src % 4 == 0] = 1  # dangling nodes
    got = pagerank(src, dst, 300, 20, 0.85, device="cpu").numpy()
    np.testing.assert_allclose(got, smoke.pagerank_oracle(src, dst, 300, 20, 0.85), rtol=1e-5)


def test_chip_smoke_gather_add_report_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.gather_add_report``, the kernel's part of the PageRank
    phase, on the CPU at a small skewed graph with the card's timers
    stubbed: the int32, int64 and dst-restricted groupings each equal the
    CSR walk, and the report carries both bounds (the chain, a hub of
    700 in-edges, the larger), the warp rows and the threshold sweep."""
    import types

    import numpy as np
    import torch

    from locust_tpu_torch.ops.kernels.pagerank import WARP_ROW_THRESHOLD
    from locust_tpu_torch.utils import roofline

    smoke = smoke_module()
    monkeypatch.setattr(smoke, "cuda_ms", lambda torch, fn, **k: (fn(), 0.5)[1])
    monkeypatch.setattr(smoke, "device_ms", lambda torch, fn, **k: (fn(), 0.25)[1])
    monkeypatch.setattr(smoke, "call_profile",
                        lambda torch, fn, kernel, **k: (fn(), (1.0, 0.5, 0.5))[1])
    monkeypatch.setattr(smoke, "sm_clock_mhz", lambda torch, fn: (fn(), 1980.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    rng = np.random.default_rng(9)
    n, e = 2000, 12000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    dst[:700] = 3
    deg = np.bincount(dst, minlength=n)
    env = types.SimpleNamespace(torch=torch, dev=torch.device("cpu"), smi="cpu")
    rep = smoke.gather_add_report(env, n, src, dst, int(deg.max()))
    assert rep["max_abs_err"] == 0.0 and rep["device_ops_per_call"] == 1.0
    assert rep["bound_ms"] == pytest.approx(
        roofline.pagerank_gather_min_bytes(n, e, index_bytes=4) / smoke.PEAK_BYTES_PER_S * 1e3)
    assert rep["bound_by"] == "bytes" and rep["bound_int64_ms"] > rep["bound_ms"]
    assert rep["chain_bound_ms"] == pytest.approx(int(deg.max()) * 4 / 1980e3)
    assert rep["larger_bound"] == "chain"
    assert rep["share_of_larger_bound"] == pytest.approx(rep["chain_bound_ms"] / 0.5)
    t = rep["warp_row_threshold"]
    assert t == WARP_ROW_THRESHOLD and rep["warp_rows"] == int((deg > t).sum())
    assert {t: v["warp_rows"] for t, v in rep["threshold_sweep"].items()} == {
        t: int((deg > t).sum()) for t in (8, 16, 32, 64, 128)}


def test_chip_smoke_counted_child_appends_its_launches(tmp_path, monkeypatch, capfdbinary):
    """``chip_smoke.py --counted-child LOG MODULE ARGS``: MODULE's main
    runs, then one JSON line with its argv and this process's launch
    counts lands in LOG; a worker instead points its maps at the same
    wrapper and appends a line for each command it handles that launched
    a kernel (the launches since its last line)."""
    import json

    from locust_tpu_torch.distributor import worker
    from locust_tpu_torch.ops.kernels.fused_fold import fused_block_preagg
    from locust_tpu_torch.ops.kernels.pagerank import gather_add
    from locust_tpu_torch.ops.kernels.partition import stable_partition
    from locust_tpu_torch.ops.kernels.sort import bitonic_sort_rows
    from locust_tpu_torch.ops.kernels.tokenize import tokenize_block_kernel

    smoke = smoke_module()
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"a b\nb c\n")
    log = str(tmp_path / "launches.jsonl")
    monkeypatch.setattr(tokenize_block_kernel, "launches", 3)
    monkeypatch.setattr(bitonic_sort_rows, "launches", 5)
    monkeypatch.setattr(fused_block_preagg, "launches", 7)
    monkeypatch.setattr(gather_add, "launches", 11)
    monkeypatch.setattr(stable_partition, "launches", 13)
    argv = [str(corpus), "--backend", "cpu", "--no-timing"]
    for _ in range(2):
        assert smoke._counted_child(log, "locust_tpu_torch.cli", argv) == 0
    assert capfdbinary.readouterr().out == b"a\t1\nb\t2\nc\t1\n" * 2
    with open(log) as f:
        lines = [json.loads(x) for x in f]
    assert lines == [{"module": "locust_tpu_torch.cli", "argv": argv, "pid": os.getpid(),
                      "tokenize": 3, "bitonic_sort": 5, "fused_fold": 7, "pagerank": 11,
                      "partition": 13}] * 2
    monkeypatch.setattr(worker, "MAP_COMMAND", worker.MAP_COMMAND)
    monkeypatch.setattr(worker, "main", lambda args: 0)
    monkeypatch.setattr(worker.Worker, "_handle", worker.Worker._handle)
    assert smoke._counted_child(log, "locust_tpu_torch.distributor.worker", ["--serve"]) == 0
    assert worker.MAP_COMMAND == (sys.executable, SMOKE, "--counted-child", log,
                                  "locust_tpu_torch.cli")
    with open(log) as f:
        assert len(f.readlines()) == 2
    # Each command a worker handles appends what it launched, if anything.
    w = worker.Worker(secret=b"s")
    try:
        assert w._handle({"cmd": "ping"}) == {"status": "ok", "pong": True}
        monkeypatch.setattr(bitonic_sort_rows, "launches", 9)
        w._handle({"cmd": "ping"})
        w._handle({"cmd": "ping"})
    finally:
        w._sock.close()
    with open(log) as f:
        lines = [json.loads(x) for x in f][2:]
    assert lines == [{"module": "locust_tpu_torch.distributor.worker", "argv": ["--serve"],
                      "pid": os.getpid(), "cmd": "ping", "tokenize": 3, "bitonic_sort": 5,
                      "fused_fold": 7, "pagerank": 11, "partition": 13,
                      "max_memory_reserved": None},
                     {"module": "locust_tpu_torch.distributor.worker", "argv": ["--serve"],
                      "pid": os.getpid(), "cmd": "ping", "tokenize": 0, "bitonic_sort": 4,
                      "fused_fold": 0, "pagerank": 0, "partition": 0,
                      "max_memory_reserved": None}]


def _top_imports(path: str) -> set:
    """The top-level package of every import in a file, at any depth."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    return names


def test_chip_smoke_imports_neither_jax_nor_locust_tpu():
    """The card has no jax: every import in the script, at any depth of
    its functions, names the port, the standard library, numpy or torch."""
    names = _top_imports(SMOKE)
    assert "locust_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "locust_tpu"}, names


def test_chip_mesh_imports_neither_jax_nor_locust_tpu():
    names = _top_imports(os.path.join(os.path.dirname(SMOKE), "chip_mesh.py"))
    assert {"chip_smoke", "locust_tpu_torch", "torch"} <= names
    assert not names & {"jax", "jaxlib", "locust_tpu"}, names
