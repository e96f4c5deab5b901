"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names (before the first dot) compared whole, so
``locust_tpu_torch`` passes and ``locust_tpu`` does not."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import bench_rig

WALK = r"""
import importlib, os, sys, json
sys.path.insert(0, ROOT)
from benchmark import harness
from benchmark.tests import bench_rig
mods = []
for dirpath, _, files in os.walk(harness.BENCH):
    for f in sorted(files):
        if not f.endswith(".py") or "tests" in dirpath.split(os.sep) or f == "run.py":
            continue
        rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3].replace(os.sep, ".")
        if "metrics" in rel.split("."):
            harness.reader(f[:-3]) if not f.startswith("_") else importlib.import_module(rel)
        else:
            importlib.import_module(rel)
        mods.append(rel)
line, _ = bench_rig.run_tiny("wc-zipf30k-batch", trace=True)
assert line["correct"]
print(json.dumps({"walked": mods, "forbidden": harness.forbidden_loaded(),
                  "port": "locust_tpu_torch" in sys.modules}))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", f"ROOT = {harness.ROOT!r}\n" + WALK],
                         capture_output=True, text=True, timeout=300, env=env, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == [] and got["port"]
    assert "benchmark.harness" in got["walked"] and "benchmark.drivers.stream" in got["walked"]


@pytest.mark.parametrize("plant", [False, True])
def test_a_run_that_holds_jax_once_its_window_closed_prints_no_line(plant, monkeypatch, capsys):
    """A tiny batch run: with a module named ``jax`` in ``sys.modules``
    when the window has closed, the report names it and prints no
    result line; without it, the line."""
    ctx, out = bench_rig.run_tiny_ctx("wc-zipf30k-batch")
    if plant:
        monkeypatch.setitem(sys.modules, "jax", sys)
    capsys.readouterr()
    rc = harness.report(harness.manifest(), ctx, out)
    printed = capsys.readouterr()
    if plant:
        assert rc == 1 and printed.out == ""
        assert "jax" in printed.err
    else:
        assert rc == 0 and json.loads(printed.out.strip().splitlines()[-1])["correct"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "locust_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_loaded() == before
    monkeypatch.setitem(sys.modules, "locust_tpu.config", sys)
    assert "locust_tpu" in harness.forbidden_loaded()


def test_no_source_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(harness.BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in harness.FORBIDDEN_MODULES, (path, n)
