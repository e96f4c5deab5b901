"""The port's static analyzer, its port-only rule forms and its gate.

R003 (host syncs in loops: torch's host reads, followed through the
call graph), R006 (python spawns pin PYTHONPATH), R007 (chip_smoke.py's
last line) and R008 (the kernels' build dir and ``*.so``) on fixtures;
then ``python -m locust_tpu_torch.analysis`` over the repo: exit 0 with
an empty baseline, one parse per file, and neither jax nor torch (nor
anything of ``locust_tpu``) loaded.  Parity with the JAX analyzer on the
shared rules: tests/test_torch_analysis.py.
"""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import glob
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from locust_tpu_torch.analysis import run_analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(root, rel, code):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    return path


def _run(root, rules, paths):
    return run_analysis(paths=paths, root=str(root), rules=rules,
                        baseline_path=str(root / "no_baseline.json"))


def _cli(*args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "locust_tpu_torch.analysis", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


# ------------------------------------------------------------------- R003

_R003_CASES = {
    "item_in_loop": ("""
        import torch

        def drain(blocks):
            return [b.sum().item() for b in blocks] + [b.item() for b in blocks]

        def total(blocks):
            n = 0
            for b in blocks:
                n += int(b.sum())
                torch.cuda.synchronize()
            return n
    """, [10, 11]),
    "through_a_helper": ("""
        import torch

        def _flag(t):
            return t.cpu()

        def fold(blocks):
            while blocks:
                _flag(blocks.pop())
    """, [5]),
    "event_wait_in_nested_def": ("""
        import torch

        def stream(blocks, ev):
            def dispatch():
                ev.synchronize()
            for b in blocks:
                dispatch()
    """, [6]),
    "conversion_of_a_bound_name": ("""
        import torch

        def _fold(t):
            return t, t.sum()

        def run(blocks, n):
            for b in blocks:
                out, flag = _fold(b)
                if bool(flag):
                    n += int(len(blocks)) + int(n)
            return n
    """, [10]),
    "outside_loops_and_in_the_iterable": ("""
        import torch

        def once(t):
            n = t.item()
            for row in t.tolist():
                n += row
            return n
    """, []),
    "reasoned_noqa": ("""
        import torch

        def drain(blocks):
            for b in blocks:
                b.numpy()  # locust: noqa[R003] host staging buffer: a view, no device
    """, []),
    "numpy_module_without_torch": ("""
        import numpy as np

        def drain(blocks):
            for b in blocks:
                b.tolist()
    """, []),
}


@pytest.mark.parametrize("case", sorted(_R003_CASES))
def test_r003_torch_host_reads(tmp_path, case):
    code, lines = _R003_CASES[case]
    _write(tmp_path, "locust_tpu_torch/hot.py", code)
    _write(tmp_path, "chip_tool.py", code)  # scripts sync at will
    _write(tmp_path, "tests/test_hot.py", code)
    res = _run(tmp_path, ["R003"], ["locust_tpu_torch", "chip_tool.py", "tests"])
    assert [(f.path, f.line) for f in res.new] == [("locust_tpu_torch/hot.py", n) for n in lines]
    assert all("host sync" in f.message for f in res.new)


def test_r003_noqa_without_reason_is_r000(tmp_path):
    _write(tmp_path, "locust_tpu_torch/hot.py", """
        import torch

        def drain(blocks):
            for b in blocks:
                b.item()  # locust: noqa[R003]
    """)
    res = _run(tmp_path, ["R003"], ["locust_tpu_torch"])
    assert sorted(f.rule_id for f in res.new) == ["R000", "R003"]


# ------------------------------------------------------------------- R006

_R006_SPAWNS = """
    import os
    import subprocess
    import sys

    def bare():
        subprocess.run([sys.executable, "-c", "pass"], timeout=5)

    def unpinned():
        env = dict(os.environ, OMP_NUM_THREADS="1")
        subprocess.Popen([sys.executable, "-m", "locust_tpu_torch"], env=env)

    def pinned(repo):
        env = dict(os.environ, PYTHONPATH=repo)
        subprocess.run([sys.executable, "-m", "locust_tpu_torch"], env=env)

    def wrapper(cmd, env, ctx):
        subprocess.run([sys.executable, *cmd], env=env)
        subprocess.run([sys.executable, *cmd], env=ctx.serve_env)

    def not_python():
        subprocess.run(["git", "status"])
"""


def test_r006_pins_pythonpath_in_the_package_and_chip_scripts(tmp_path):
    for rel in ("locust_tpu_torch/spawn.py", "chip_x.py", "tests/test_spawn.py"):
        _write(tmp_path, rel, _R006_SPAWNS)
    res = _run(tmp_path, ["R006"], ["locust_tpu_torch", "chip_x.py", "tests"])
    got = sorted((f.path, f.line) for f in res.new)
    assert got == [("chip_x.py", 7), ("chip_x.py", 11),
                   ("locust_tpu_torch/spawn.py", 7), ("locust_tpu_torch/spawn.py", 11)]
    msgs = {f.line: f.message for f in res.new}
    assert "inherited environment" in msgs[7] and "PYTHONPATH" in msgs[11]
    assert "JAX_PLATFORMS" not in " ".join(msgs.values())


# ------------------------------------------------------------------- R007

_R007_OK = """
    import json
    import sys

    def log(*parts):
        print(*parts, flush=True)

    def main():
        log("phase one")
        print(json.dumps({"kernels": []}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu"}}))
        return 0

    if __name__ == "__main__":
        raise SystemExit(main())
"""


@pytest.mark.parametrize("code,want", [
    (_R007_OK, []),
    (_R007_OK.replace("        return 0", "        log('done')\n        return 0"),
     [(12, "statement after the last line")]),
    (_R007_OK.replace("        return 0",
                      '        if sys.argv:\n            print(json.dumps({"ok": False}))\n'
                      "        return 0"),
     [(12, "statement after the last line"), (13, "exactly ONE site")]),
    (_R007_OK.replace('        print(json.dumps({"ok": True, "device": {"platform": "gpu"}}))\n', ""),
     [(1, "exactly ONE site")]),
], ids=["contract", "log_after", "second_site", "no_site"])
def test_r007_chip_smoke_last_line(tmp_path, code, want):
    _write(tmp_path, "chip_smoke.py", code)
    _write(tmp_path, "chip_mesh.py", code.replace('"ok"', '"okay"'))  # no last-line contract
    res = _run(tmp_path, ["R007"], ["chip_smoke.py", "chip_mesh.py"])
    got = sorted((f.line, f.message) for f in res.new)
    assert [ln for ln, _ in got] == [ln for ln, _ in want]
    for (_, msg), (_, frag) in zip(got, want):
        assert frag in msg


# ------------------------------------------------------------------- R008


def _git(root, *args):
    subprocess.run(["git", "-C", str(root), *args], check=True, capture_output=True,
                   timeout=60)


@pytest.mark.parametrize("ignore,tracked,want", [
    ("__pycache__/\n*.pyc\n*.so\nbuild/\n", [], []),
    ("__pycache__/\n*.pyc\n*.so\n", [], [".gitignore"]),
    ("__pycache__/\n*.pyc\nbuild/\n", ["lib/k.so"], [".gitignore", "lib/k.so"]),
], ids=["covered", "build_dir_not_ignored", "so_tracked"])
def test_r008_build_dir_and_shared_objects(tmp_path, ignore, tracked, want):
    _write(tmp_path, "locust_tpu_torch/_build.py", """
        from pathlib import Path

        BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "locust_tpu_torch"
    """)
    (tmp_path / ".gitignore").write_text(ignore)
    _git(tmp_path, "init", "-q")
    for rel in tracked:
        _write(tmp_path, rel, "x")
        _git(tmp_path, "add", "-f", rel)
    res = _run(tmp_path, ["R008"], ["locust_tpu_torch"])
    assert sorted(f.path for f in res.new) == want
    if ".gitignore" in want:
        assert any("'build/'" in f.message or "'*.so'" in f.message for f in res.new)


# ------------------------------------------------------------------- gate


def test_gate_exits_zero_on_the_repo_without_jax_or_torch():
    code = textwrap.dedent("""
        import json, sys
        from locust_tpu_torch.analysis import core, rpcflow
        from locust_tpu_torch.analysis.__main__ import main
        core.reset_parse_count()
        rpcflow.reset_build_count()
        rc = main(["--json"])
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "locust_tpu"))
        print(json.dumps({"rc": rc, "bad": bad, "parses": core.parse_count(),
                          "rpc_builds": rpcflow.build_count()}))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report_text, tail = out.stdout.rsplit("\n{", 1)
    report, tail = json.loads(report_text), json.loads("{" + tail)
    assert tail["rc"] == 0 and tail["bad"] == [], (tail, report["findings"])
    assert report["new"] == 0 and report["total"] == 0
    assert report["files"] >= 90 and tail["parses"] == report["files"]
    assert tail["rpc_builds"] == 1  # R016 and R018 share one message-flow build
    assert "R002" not in report["rules"] and "R003" in report["rules"]
    with open(os.path.join(REPO, "locust_tpu_torch/analysis/baseline.json")) as f:
        assert json.load(f) == {"version": 1, "findings": {}}


def test_cli_list_rules_rule_filter_sarif_and_changed(tmp_path):
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    lines = dict(ln.split("  ", 1) for ln in listed.stdout.splitlines())
    assert lines["R002"].startswith("absent") and lines["R010"].startswith("absent")
    assert len(lines) == 18
    absent = _cli("--rule", "R010")
    assert absent.returncode == 2 and "absent" in absent.stderr
    _write(tmp_path, "pyproject.toml", "")
    _write(tmp_path, "locust_tpu_torch/serve/hot.py", """
        def wait_for(worker):
            worker.join()
    """)
    sarif = tmp_path / "out.sarif"
    got = _cli("--root", str(tmp_path), "--rule", "R013", "--sarif", str(sarif),
               "--baseline", str(tmp_path / "b.json"), "locust_tpu_torch", cwd=str(tmp_path))
    assert got.returncode == 1 and "R013" in got.stdout
    doc = json.loads(sarif.read_text())
    assert doc["runs"][0]["results"][0]["ruleId"] == "R013"
    wrote = _cli("--root", str(tmp_path), "--rule", "R013", "--write-baseline",
                 "--baseline", str(tmp_path / "b.json"), "locust_tpu_torch", cwd=str(tmp_path))
    assert wrote.returncode == 0
    again = _cli("--root", str(tmp_path), "--rule", "R013", "--json",
                 "--baseline", str(tmp_path / "b.json"), "locust_tpu_torch", cwd=str(tmp_path))
    assert again.returncode == 0 and json.loads(again.stdout)["new"] == 0
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", "-A")
    _git(tmp_path, "-c", "user.email=a@b", "-c", "user.name=a", "commit", "-qm", "x")
    scoped = _cli("--root", str(tmp_path), "--rule", "R013", "--changed",
                  "--baseline", str(tmp_path / "none.json"), "locust_tpu_torch",
                  cwd=str(tmp_path))
    assert scoped.returncode == 0, scoped.stdout + scoped.stderr


# A phantom entry added to each of the port's real registries must fail
# the port's gate (the tree copied whole: package, docs, the port's
# suite).  (rule, module, anchor, replacement, phantom, findings)
_MUTATIONS = [
    ("R004", "utils/faultplan.py", "SITES = {", 'SITES = {\n    "io.phantom": ("corrupt",),',
     "io.phantom", 3),  # unhooked, untested, undocumented
    ("R009", "obs/names.py", "NAMES = {", 'NAMES = {\n    "phantom.span": "span",',
     "phantom.span", 1),  # never emitted
    ("R011", "serve/jobs.py", "ERROR_CODES = (", 'ERROR_CODES = (\n    "phantom_code",',
     "phantom_code", 3),  # never emitted, undocumented, untested
    ("R014", "plan/nodes.py", "NODE_KINDS = (", 'NODE_KINDS = (\n    "phantom_kind",',
     "phantom_kind", 4),  # never lowered, untested, undocumented, undistributed
    ("R015", "plan/optimize.py", "REWRITE_RULES = (", 'REWRITE_RULES = (\n    "phantom_rule",',
     "phantom_rule", 3),  # never applied, untested, undocumented
    ("R018", "distributor/protocol.py", 'COMMANDS = ("ping",', 'COMMANDS = ("phantom_cmd", "ping",',
     "phantom_cmd", 1),  # no plane classification
]


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_tree")
    shutil.copytree(os.path.join(REPO, "locust_tpu_torch"), root / "locust_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(REPO, "docs"), root / "docs")
    (root / "tests").mkdir()
    for path in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")):
        shutil.copy(path, root / "tests")
    return root


@pytest.mark.parametrize("rule,module,anchor,phantom_src,phantom,n", _MUTATIONS,
                         ids=[m[0] for m in _MUTATIONS])
def test_a_phantom_entry_in_a_real_registry_fails_the_gate(port_tree, rule, module, anchor,
                                                            phantom_src, phantom, n):
    path = port_tree / "locust_tpu_torch" / module
    faithful = path.read_text()
    assert not _run(port_tree, [rule], ["locust_tpu_torch"]).new  # the copy is green
    assert faithful.count(anchor) == 1
    try:
        path.write_text(faithful.replace(anchor, phantom_src))
        res = _run(port_tree, [rule], ["locust_tpu_torch"])
    finally:
        path.write_text(faithful)
    assert len(res.new) == n and all(phantom in f.message for f in res.new), \
        [f.format() for f in res.new]
