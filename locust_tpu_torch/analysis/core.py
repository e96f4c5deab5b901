"""Rule engine: one AST parse per file, per-rule findings, noqa + baseline.

Design constraints (docs/ANALYSIS.md):

  * single pass — each file is read and ``ast.parse``d exactly once; every
    rule sees the same ``SourceFile`` objects;
  * findings are stable — a ``Finding``'s fingerprint hashes the rule id,
    the repo-relative path and the CONTENT of the flagged line (not its
    number), so a baseline survives unrelated edits above the finding;
  * suppression is loud — ``# locust: noqa[R00x] reason`` on the flagged
    line suppresses that rule THERE only, and an empty reason does not
    suppress: it raises R000 instead (a suppression nobody can audit is
    drift waiting to happen);
  * the engine never imports the code it checks: no torch, no jax and
    nothing of either package (the card's host has no jax, and the gate
    must not pay for a torch import).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import time

from locust_tpu_torch.analysis.config import Layout

# R000 is the engine's own rule id: unparseable files and unauditable
# (reason-less) suppressions.  It cannot be suppressed.
ENGINE_RULE = "R000"

# Parse accounting: the one-parse-per-file economy is a pinned contract
# (tests/test_torch_analysis_gate.py) — every ``ast.parse`` of checked
# source goes through ``parse_text`` so the test can count them.
_parse_count = 0


def parse_text(text: str) -> ast.Module:
    global _parse_count
    _parse_count += 1
    return ast.parse(text)


def parse_count() -> int:
    return _parse_count


def reset_parse_count() -> None:
    global _parse_count
    _parse_count = 0

_NOQA_RE = re.compile(
    r"#\s*locust:\s*noqa\[([A-Za-z0-9, ]+)\]\s*(.*?)\s*$"
)


@dataclasses.dataclass
class Finding:
    """One rule violation at a file:line."""

    rule_id: str
    path: str  # repo-relative, posix separators
    line: int
    col: int
    message: str
    severity: str = "error"
    baselined: bool = False
    fingerprint: str = ""
    # False marks findings that are never acceptable debt (e.g. R016
    # phantom cmds: a cmd with no handler) — ``--write-baseline`` refuses
    # to record them instead of silently burying a dead RPC.
    baselineable: bool = True

    def format(self) -> str:
        tag = " [baselined]" if self.baselined else ""
        return (
            f"{self.path}:{self.line}:{self.col} {self.rule_id} "
            f"{self.severity}: {self.message}{tag}"
        )

    def as_dict(self) -> dict:
        return {
            "rule": self.rule_id,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "severity": self.severity,
            "baselined": self.baselined,
            "fingerprint": self.fingerprint,
        }


class SourceFile:
    """One parsed source file: text, lines, AST, and its noqa directives."""

    def __init__(self, abspath: str, rel: str, text: str):
        self.abspath = abspath
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree: ast.Module | None = None
        self.parse_error: SyntaxError | None = None
        try:
            self.tree = parse_text(text)
        except SyntaxError as e:
            self.parse_error = e
        # line number -> (set of rule ids, reason)
        self.noqa: dict[int, tuple[set[str], str]] = {}
        for i, ln in enumerate(self.lines, start=1):
            m = _NOQA_RE.search(ln)
            if m:
                ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
                self.noqa[i] = (ids, m.group(2).strip())

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


class Rule:
    """Base rule.  Subclasses set ``rule_id``/``title`` and override one
    (or more) of the check hooks.  ``check_file`` runs once per analyzed
    python file; ``check_project`` runs once with the full file set (for
    cross-file registry rules) and may emit findings on non-analyzed
    paths (e.g. docs/FAULTS.md); ``check_program`` runs once with the
    phase-1 whole-program summaries (summaries.Program) for the
    interprocedural rules."""

    rule_id = "R999"
    title = "unnamed rule"

    def __init__(self, layout=None):
        self.layout = layout if layout is not None else Layout()

    def check_file(self, f: SourceFile, root: str):
        return ()

    def check_project(self, files: list[SourceFile], root: str):
        return ()

    def check_program(self, program):
        return ()


def find_source(files: list[SourceFile], rel: str) -> SourceFile | None:
    """Already-parsed SourceFile for a repo-relative path — registry
    rules use this instead of re-reading/re-parsing their anchor modules
    (the one-parse-per-file economy)."""
    for f in files:
        if f.rel == rel:
            return f
    return None


def parse_registry_module(
    files: list[SourceFile], root: str, rel: str
) -> ast.Module | None:
    """Tree for ``rel``: the phase-1 parse when the file is in the
    analyzed set (the normal case), a counted one-off parse otherwise
    (fixture trees that point a rule at an unanalyzed path)."""
    sf = find_source(files, rel)
    if sf is not None:
        return sf.tree
    try:
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            return parse_text(f.read())
    except (OSError, SyntaxError):
        return None


@dataclasses.dataclass
class AnalysisResult:
    findings: list[Finding]  # new + baselined (suppressed excluded)
    new: list[Finding]
    suppressed: int
    n_files: int
    rules: list[str]
    # Per-rule wall time (ms, 1 decimal): a slow run is attributable to
    # a rule, not just "the run".
    rule_ms: dict[str, float] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "files": self.n_files,
            "rules": self.rules,
            "rule_ms": self.rule_ms,
            "suppressed": self.suppressed,
            "total": len(self.findings),
            "new": len(self.new),
            "findings": [f.as_dict() for f in self.findings],
        }


def _iter_py_files(paths: list[str], root: str):
    """Expand files/dirs to .py files, skipping caches and VCS dirs."""
    skip_dirs = {"__pycache__", ".git", ".pytest_cache", ".hypothesis", "build"}
    seen = set()
    for p in paths:
        absp = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(absp):
            if absp not in seen:
                seen.add(absp)
                yield absp
        elif os.path.isdir(absp):
            for dirpath, dirnames, filenames in os.walk(absp):
                dirnames[:] = sorted(
                    d for d in dirnames if d not in skip_dirs
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        fp = os.path.join(dirpath, fn)
                        if fp not in seen:
                            seen.add(fp)
                            yield fp


def load_files(paths: list[str], root: str) -> list[SourceFile]:
    files = []
    for absp in _iter_py_files(paths, root):
        try:
            with open(absp, encoding="utf-8", errors="replace") as fh:
                text = fh.read()
        except OSError:
            continue
        rel = os.path.relpath(absp, root)
        files.append(SourceFile(absp, rel, text))
    return files


def _fingerprint(f: Finding, line_text: str, occurrence: int) -> str:
    h = hashlib.sha256(
        f"{f.rule_id}|{f.path}|{line_text}|{occurrence}".encode()
    ).hexdigest()
    return h[:16]


def _assign_fingerprints(findings: list[Finding], by_rel: dict) -> None:
    """Content-addressed fingerprints, disambiguated by occurrence index
    so two identical findings on identical lines stay distinct."""
    counts: dict[tuple, int] = {}
    for f in findings:
        sf = by_rel.get(f.path)
        line_text = sf.line_text(f.line) if sf is not None else ""
        key = (f.rule_id, f.path, line_text)
        occ = counts.get(key, 0)
        counts[key] = occ + 1
        f.fingerprint = _fingerprint(f, line_text, occ)


def run_analysis(
    paths: list[str] | None = None,
    root: str | None = None,
    rules: list[str] | None = None,
    baseline_path: str | None = None,
    layout=None,
) -> AnalysisResult:
    """Run the rule set over ``paths`` (defaults: ``config.DEFAULTS``)
    with every anchor taken from ``layout`` (default: the port's,
    ``config.Layout()``).  Returns every finding with the baselined/new
    split applied; ``result.new`` non-empty is the gate failure."""
    from locust_tpu_torch.analysis import config as cfg
    from locust_tpu_torch.analysis.baseline import load_baseline
    from locust_tpu_torch.analysis.registry import get_rules

    root = os.path.abspath(root or cfg.find_root())
    conf = cfg.load_config(root)
    paths = list(paths) if paths else list(conf["paths"])
    if baseline_path is None:
        baseline_path = os.path.join(root, conf["baseline"])
    rule_objs = get_rules(rules, layout)
    files = load_files(paths, root)
    by_rel = {f.rel: f for f in files}

    findings: list[Finding] = []
    for sf in files:
        if sf.parse_error is not None:
            findings.append(
                Finding(
                    ENGINE_RULE,
                    sf.rel,
                    sf.parse_error.lineno or 1,
                    sf.parse_error.offset or 0,
                    f"file does not parse: {sf.parse_error.msg}",
                )
            )
    parsed = [f for f in files if f.tree is not None]
    # Phase 1: one pass over the already-parsed trees builds the
    # whole-program summaries + call graph; phase 2 runs the rules.
    # Skipped entirely when no selected rule is interprocedural — the
    # single-rule dev loop (--rule R004) should not pay for summaries
    # it never reads.
    program = None
    if any(
        type(r).check_program is not Rule.check_program for r in rule_objs
    ):
        from locust_tpu_torch.analysis.summaries import build_program

        program = build_program(parsed, root)
    rule_ms: dict[str, float] = {}
    for rule in rule_objs:
        t0 = time.perf_counter()
        for sf in parsed:
            findings.extend(rule.check_file(sf, root))
        findings.extend(rule.check_project(parsed, root))
        if program is not None:
            findings.extend(rule.check_program(program))
        rule_ms[rule.rule_id] = round(
            (time.perf_counter() - t0) * 1000.0, 1
        )

    # noqa suppression (reason mandatory; R000 is never suppressible).
    kept: list[Finding] = []
    suppressed = 0
    for f in findings:
        sf = by_rel.get(f.path)
        directive = sf.noqa.get(f.line) if sf is not None else None
        if (
            directive is not None
            and f.rule_id != ENGINE_RULE
            and f.rule_id in directive[0]
        ):
            if directive[1]:
                suppressed += 1
                continue
            kept.append(f)
            kept.append(
                Finding(
                    ENGINE_RULE,
                    f.path,
                    f.line,
                    f.col,
                    f"noqa[{f.rule_id}] has no reason — a suppression "
                    "must say why (docs/ANALYSIS.md)",
                )
            )
        else:
            kept.append(f)

    kept.sort(key=lambda f: (f.path, f.line, f.rule_id))
    _assign_fingerprints(kept, by_rel)
    known = load_baseline(baseline_path)
    for f in kept:
        # R000 (engine self-checks) is never baselineable: an unparseable
        # file or a reasonless noqa must block even if someone wrote it
        # into the baseline file by hand.
        f.baselined = f.rule_id != ENGINE_RULE and f.fingerprint in known
    new = [f for f in kept if not f.baselined]
    return AnalysisResult(
        findings=kept,
        new=new,
        suppressed=suppressed,
        n_files=len(files),
        rules=[r.rule_id for r in rule_objs],
        rule_ms=rule_ms,
    )


# ------------------------------------------------------------- changed scope


_HUNK_RE = re.compile(r"^@@ -\d+(?:,\d+)? \+(\d+)(?:,(\d+))? @@")


def changed_lines(
    root: str, ref: str = "HEAD"
) -> dict[str, set[int] | None]:
    """{repo-relative path: new-side line numbers touched (None = the
    whole file)} vs a git ref — the ``--changed`` pre-commit scope.
    Untracked (not-yet-added) files count whole-file: ``git diff`` never
    lists them, and a brand-new module silently scoped to nothing would
    be the exact trap the loud ValueError below exists to prevent.
    Raises ValueError when git cannot produce the diff (not a repo,
    unknown ref)."""
    try:
        out = subprocess.run(
            ["git", "-C", root, "diff", "--no-color", "--unified=0",
             ref, "--"],
            capture_output=True, text=True, timeout=60,
        )
        untracked = subprocess.run(
            ["git", "-C", root, "ls-files", "--others",
             "--exclude-standard"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        raise ValueError(f"--changed needs git: {e}")
    if out.returncode != 0:
        raise ValueError(
            f"git diff {ref!r} failed: {out.stderr.strip() or out.stdout}"
        )
    changed: dict[str, set[int] | None] = {}
    current: set[int] | None = None
    for line in out.stdout.splitlines():
        if line.startswith("+++ "):
            path = line[4:].strip()
            if path.startswith("b/"):
                path = path[2:]
            if path == "/dev/null":
                current = None
            else:
                current = set()
                changed[path] = current
        elif current is not None:
            m = _HUNK_RE.match(line)
            if m:
                start = int(m.group(1))
                count = int(m.group(2)) if m.group(2) is not None else 1
                current.update(range(start, start + max(count, 1)))
    if untracked.returncode == 0:
        for path in untracked.stdout.splitlines():
            if path:
                changed[path.strip()] = None  # whole file is new
    return changed


def scope_to_changed(
    result: AnalysisResult, changed: dict[str, set[int] | None]
) -> AnalysisResult:
    """Findings restricted to lines touched by the diff.  Full-repo
    analysis already ran (fingerprints, baseline and suppression are
    whole-tree facts); this only narrows what is REPORTED/gated."""

    def hit(f: Finding) -> bool:
        if f.path not in changed:
            return False
        lines = changed[f.path]
        return lines is None or f.line in lines

    kept = [f for f in result.findings if hit(f)]
    return AnalysisResult(
        findings=kept,
        new=[f for f in kept if not f.baselined],
        suppressed=result.suppressed,
        n_files=result.n_files,
        rules=result.rules,
        rule_ms=result.rule_ms,
    )


# --------------------------------------------------------------- AST helpers
# Shared by the rule modules; kept here so each rule stays ~a screenful.


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover  # locust: noqa[R017] unparse is total on parsed trees; "" is the documented fallback and there is no logger inside the engine to record to
        return ""


def call_name(call: ast.Call) -> str:
    """Dotted name of a call's callee: ``torch.cuda.synchronize`` ->
    "torch.cuda.synchronize"."""
    return unparse(call.func)


def const_int(node: ast.AST) -> int | None:
    """Constant-fold an int expression over + - * << (re-spelled wire
    constants are arithmetic like ``64 * 1024 * 1024``)."""
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if isinstance(node, ast.BinOp):
        left, right = const_int(node.left), const_int(node.right)
        if left is None or right is None:
            return None
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.Mult):
            return left * right
        if isinstance(node.op, ast.LShift) and 0 <= right < 128:
            return left << right
    return None


def module_functions(tree: ast.Module) -> dict[str, list[ast.FunctionDef]]:
    """name -> every def/async def with that name anywhere in the module
    (methods and nested defs included; heuristic resolution by name)."""
    out: dict[str, list] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


def emit_json(result: AnalysisResult) -> str:
    return json.dumps(result.as_dict(), indent=2, sort_keys=True)
