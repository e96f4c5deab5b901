"""The port's static analyzer (``locust_tpu_torch.analysis``) held to the
JAX package's (``locust_tpu.analysis``) on every rule they share.

Each fixture test of tests/test_analysis.py for a shared rule runs
unchanged here, with its analyzer calls routed through ``_both``: the
JAX analyzer checks the fixture tree as written (under ``locust_tpu/``),
the port's checks a mirror of it (under ``locust_tpu_torch/``, the
suite's files renamed ``tests/test_torch_*.py``), and the two must
report the same ``(rule, path within the package, line, message)`` set
before the test's own assertions see the JAX result.  Noqa, baseline,
R000 and SARIF are held on fixtures of a shared rule (R013), and both
analyzers sweep a copy of ``locust_tpu/`` with its suppressions
stripped.  The port-only forms (R003, R006-R008) and the gate are in
tests/test_torch_analysis_gate.py.
"""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import ast
import json
import os
import re
import shutil
import textwrap

import pytest

import test_analysis as jax_suite
from locust_tpu.analysis import run_analysis as jax_run
from locust_tpu.analysis.baseline import write_baseline as jax_write_baseline
from locust_tpu.analysis.registry import all_rules as jax_all_rules
from locust_tpu.analysis.sarif import sarif_report as jax_sarif
from locust_tpu_torch.analysis import run_analysis as port_run
from locust_tpu_torch.analysis.baseline import write_baseline as port_write_baseline
from locust_tpu_torch.analysis.config import Layout
from locust_tpu_torch.analysis.registry import ABSENT, all_rules as port_all_rules
from locust_tpu_torch.analysis.sarif import sarif_report as port_sarif

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG, PORT_PKG = "locust_tpu", "locust_tpu_torch"

# The rules whose form is the same in both packages.  R003 (host syncs:
# jax's block_until_ready vs torch's host reads), R006 (PYTHONPATH only:
# the card's host has no jax), R007 (chip_smoke.py's last line, not
# bench.py's) and R008 (plus the kernels' build dir and *.so) have port
# forms; R002 and R010 are absent from the port.
SHARED = ("R001", "R004", "R005", "R009", "R011", "R012", "R013", "R014",
          "R015", "R016", "R017", "R018")
JAX_DEFAULT_PATHS = ["locust_tpu", "scripts", "tests", "bench.py", "__graft_entry__.py"]

_WORD = re.compile(r"\blocust_tpu\b")


def _port_rel(rel: str) -> str:
    """A fixture tree's path -> its mirror's."""
    parts = rel.split("/")
    if parts[0] == PKG:
        parts[0] = PORT_PKG
    elif parts[0] == "tests" and len(parts) == 2 and parts[1].endswith(".py"):
        name = parts[1]
        parts[1] = "test_torch_" + (name[5:] if name.startswith("test_") else name)
    return "/".join(parts)


def _mirror(root: str, dst: str) -> None:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            src = os.path.join(dirpath, fn)
            rel = os.path.relpath(src, root).replace(os.sep, "/")
            out = os.path.join(dst, _port_rel(rel))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            if fn.endswith(".py"):
                with open(src, encoding="utf-8", errors="replace") as f:
                    text = f.read()
                with open(out, "w", encoding="utf-8") as f:
                    f.write(_WORD.sub(PORT_PKG, text))
            else:
                shutil.copyfile(src, out)


def _norm_path(path: str, port: bool) -> str:
    if path in ("tests/test_faults.py", "tests/test_torch_*.py"):
        return "<suite>"
    parts = path.split("/")
    if parts[0] == (PORT_PKG if port else PKG):
        return "<pkg>/" + "/".join(parts[1:])
    if parts[0] == "tests" and len(parts) == 2:
        name = parts[1]
        stem = name[len("test_torch_"):] if port else (name[5:] if name.startswith("test_") else name)
        return "tests/" + stem
    return path


def _norm_message(msg: str, port: bool) -> str:
    if port:
        msg = msg.replace(PORT_PKG, PKG).replace("tests/test_torch_*.py", "<suite>")
    else:
        msg = msg.replace("tests/test_faults.py", "<suite>")
    return re.sub(r"\bPR \d+(/\d+)? ", "", msg)


def _norm(result, rules, port: bool) -> set:
    return {(f.rule_id, _norm_path(f.path, port), f.line, _norm_message(f.message, port))
            for f in result.new if f.rule_id in rules or f.rule_id == "R000"}


class _Both:
    """``run_analysis`` for tests/test_analysis.py: runs both analyzers,
    asserts they agree on the shared rules, returns the JAX result."""

    def __init__(self, workdir):
        self.workdir = workdir
        self.compared = 0

    def __call__(self, paths=None, root=None, rules=None, baseline_path=None):
        jres = jax_run(paths=paths, root=root, rules=rules, baseline_path=baseline_path)
        shared = [r for r in (rules or SHARED) if r in SHARED]
        if not shared:
            return jres
        self.compared += 1
        mirror = os.path.join(self.workdir, f"port{self.compared}")
        _mirror(root, mirror)
        base = None
        if baseline_path is not None:
            base = os.path.join(mirror, _port_rel(os.path.relpath(baseline_path, root)))
        pres = port_run(paths=[_port_rel(p) for p in (paths or JAX_DEFAULT_PATHS)],
                        root=mirror, rules=shared, baseline_path=base)
        want, got = _norm(jres, shared, False), _norm(pres, shared, True)
        assert got == want, (sorted(want - got), sorted(got - want))
        return jres


def _fixture_tests() -> list[str]:
    """tests/test_analysis.py's tests whose analyzer calls name a shared
    rule (read from its source, so a new fixture joins on its own)."""
    tree = ast.parse(open(jax_suite.__file__, encoding="utf-8").read())
    names = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        if [a.arg for a in fn.args.args] != ["tmp_path"]:
            continue
        if "subprocess" in ast.unparse(fn) or "_git(" in ast.unparse(fn):
            continue  # CLI and git-scope tests: the gate file covers the port's
        rules = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = ast.unparse(node.func)
            arg = node.args[1] if callee == "_run" and len(node.args) > 1 else next(
                (k.value for k in node.keywords if k.arg == "rules"), None)
            if callee in ("_run", "run_analysis") and isinstance(arg, ast.List):
                rules |= {e.value for e in arg.elts if isinstance(e, ast.Constant)}
        if rules and rules <= set(SHARED):
            names.append(fn.name)
    return names


FIXTURE_TESTS = _fixture_tests()


def test_every_shared_rule_has_fixture_parity_cases():
    covered = {m.group(1).upper() for m in
               (re.match(r"test_(r0\d\d)_", n) for n in FIXTURE_TESTS) if m}
    assert covered == set(SHARED), sorted(set(SHARED) - covered)
    assert set(port_all_rules()) | set(ABSENT) == set(jax_all_rules())


@pytest.mark.parametrize("name", FIXTURE_TESTS)
def test_fixture_parity(name, tmp_path, monkeypatch):
    (tmp_path / "tree").mkdir()
    both = _Both(str(tmp_path))
    monkeypatch.setattr(jax_suite, "run_analysis", both)
    getattr(jax_suite, name)(tmp_path / "tree")
    assert both.compared >= 1


# ------------------------------------------ noqa, baseline, R000, SARIF

_R013_HOT = """
    def wait_for(worker):
        worker.join(){tail}
"""


def _pair(tmp_path, code: str, rel: str = "serve/hot.py"):
    """The same module under each package; returns the two roots."""
    roots = []
    for pkg in (PKG, PORT_PKG):
        root = tmp_path / pkg
        path = root / pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(code))
        roots.append(root)
    return roots


def _runs(roots, rules=("R013",), baselines=(None, None)):
    jroot, proot = roots
    jres = jax_run(paths=[PKG], root=str(jroot), rules=list(rules),
                   baseline_path=baselines[0] or str(jroot / "none.json"))
    pres = port_run(paths=[PORT_PKG], root=str(proot), rules=list(rules),
                    baseline_path=baselines[1] or str(proot / "none.json"))
    return jres, pres


@pytest.mark.parametrize("tail,want_new,want_suppressed", [
    ("", ["R013"], 0),
    ("  # locust: noqa[R013] the worker exits on its own deadline", [], 1),
    ("  # locust: noqa[R013]", ["R000", "R013"], 0),
    ("  # locust: noqa[R005] wrong rule id", ["R013"], 0),
], ids=["unsuppressed", "noqa_with_reason", "noqa_without_reason", "noqa_other_rule"])
def test_noqa_parity(tmp_path, tail, want_new, want_suppressed):
    jres, pres = _runs(_pair(tmp_path, _R013_HOT.format(tail=tail)))
    for res, port in ((jres, False), (pres, True)):
        assert sorted(f.rule_id for f in res.new) == want_new
        assert res.suppressed == want_suppressed
    assert _norm(jres, SHARED, False) == _norm(pres, SHARED, True)


def test_syntax_error_parity(tmp_path):
    jres, pres = _runs(_pair(tmp_path, "def f(:\n"))
    assert [f.rule_id for f in pres.new] == ["R000"]
    assert _norm(jres, SHARED, False) == _norm(pres, SHARED, True)


def test_baseline_parity_roundtrip_line_drift_and_r000(tmp_path):
    roots = _pair(tmp_path, _R013_HOT.format(tail="  # locust: noqa[R013]"))
    bases = [str(r / "baseline.json") for r in roots]
    jres, pres = _runs(roots, baselines=bases)
    jax_write_baseline(bases[0], jres.findings)  # R000 included on purpose
    port_write_baseline(bases[1], pres.findings)
    jres, pres = _runs(roots, baselines=bases)
    for res in (jres, pres):
        assert [f.rule_id for f in res.new] == ["R000"]  # R000 is never baselined
        assert [f.rule_id for f in res.findings if f.baselined] == ["R013"]
    for root, pkg in zip(roots, (PKG, PORT_PKG)):  # unrelated drift above the line
        path = root / pkg / "serve/hot.py"
        path.write_text("# header\n" + path.read_text())
    jres, pres = _runs(roots, baselines=bases)
    for res in (jres, pres):
        assert [(f.rule_id, f.line) for f in res.new] == [("R000", 4)]
        assert [(f.rule_id, f.line) for f in res.findings if f.baselined] == [("R013", 4)]
    assert json.load(open(bases[0]))["version"] == json.load(open(bases[1]))["version"]
    assert _norm(jres, SHARED, False) == _norm(pres, SHARED, True)


def test_sarif_parity(tmp_path):
    jres, pres = _runs(_pair(tmp_path, _R013_HOT.format(tail="")))
    jdoc = jax_sarif(jres, {"R013": jax_all_rules()["R013"]})
    pdoc = port_sarif(pres, {"R013": port_all_rules()["R013"]})
    jrun, prun = jdoc["runs"][0], pdoc["runs"][0]
    assert (jdoc["version"], jdoc["$schema"]) == (pdoc["version"], pdoc["$schema"])
    assert jrun["tool"]["driver"]["rules"] == prun["tool"]["driver"]["rules"]
    [jr], [pr] = jrun["results"], prun["results"]
    assert pr["locations"][0]["physicalLocation"]["artifactLocation"]["uri"] == \
        f"{PORT_PKG}/serve/hot.py"
    for r in (jr, pr):
        del r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"]
        del r["partialFingerprints"]  # hashes the path
    assert jr == pr


# ------------------------------------------- the JAX tree, stripped

_NOQA = re.compile(r"\s*#\s*locust:\s*noqa\[[^\]]*\].*$")


def test_both_analyzers_agree_on_the_jax_tree_with_its_suppressions_stripped(tmp_path):
    stripped = 0
    for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, PKG)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            src = os.path.join(dirpath, fn)
            out = tmp_path / os.path.relpath(src, REPO)
            out.parent.mkdir(parents=True, exist_ok=True)
            lines = open(src, encoding="utf-8").read().split("\n")
            kept = [_NOQA.sub("", ln) for ln in lines]
            stripped += sum(a != b for a, b in zip(lines, kept))
            out.write_text("\n".join(kept))
    shutil.copytree(os.path.join(REPO, "docs"), tmp_path / "docs")
    assert stripped == 17
    rules = list(SHARED)
    jres = jax_run(paths=[PKG], root=str(tmp_path), rules=rules,
                   baseline_path=str(tmp_path / "none.json"))
    pres = port_run(paths=[PKG], root=str(tmp_path), rules=rules,
                    baseline_path=str(tmp_path / "none.json"),
                    layout=Layout(package=PKG, tests="tests/test_faults.py",
                                  analyzer_tests="tests/test_analysis.py"))
    want = {(f.rule_id, f.path, f.line, f.message) for f in jres.new}
    got = {(f.rule_id, f.path, f.line, re.sub(r"\bPR \d+(/\d+)? ", "", f.message))
           for f in pres.new}
    want = {(r, p, ln, re.sub(r"\bPR \d+(/\d+)? ", "", m)) for r, p, ln, m in want}
    assert got == want, (sorted(want - got)[:5], sorted(got - want)[:5])
    assert {r for r, *_ in want} >= {"R017"}  # the stripped R017 lines fire in both
