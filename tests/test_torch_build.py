"""PyTorch port, the parts of the CUDA build and of ``chip_smoke.py`` that
the CPU can check: the build is keyed by the sources, a missing CUDA
compiler raises, the smoke script refuses to run without a GPU or without
the package beside it, and its WordCount oracle agrees with the port's
engine on the CPU."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

from locust_tpu_torch import _build
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.engine import MapReduceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.dirname(script))
    out = subprocess.run(
        [sys.executable, script], env=env, cwd=os.path.dirname(script),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "chip_smoke:" in out.stderr


def test_chip_smoke_oracle_equals_the_port_engine():
    """The smoke script's oracle is independent of the code under test;
    on the CPU, at the CLI's widths, both give the same host pairs."""
    smoke = _smoke_module()
    lines, nbytes = smoke.replicated_corpus(200_000)
    cfg = EngineConfig(sort_mode="bitonic", use_pallas=True, block_lines=1024)
    assert nbytes >= 200_000 and len(lines) > 2 * cfg.block_lines
    rows = bytes_ops.strings_to_rows(lines, cfg.line_width)
    res = MapReduceEngine(cfg, device="cpu").run_fused(rows)
    oracle = smoke.oracle_wordcount(lines, cfg.line_width, cfg.emits_per_line, cfg.key_width)
    assert res.to_host_pairs() == sorted(oracle.items())
    assert not res.truncated


def test_chip_smoke_bound_names_the_larger_time():
    smoke = _smoke_module()
    t, by = smoke.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = smoke.bound_ms(1.0, 67e9)
    assert by == "operations" and t == pytest.approx(1.0)
