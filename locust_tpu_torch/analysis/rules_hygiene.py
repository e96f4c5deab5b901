"""R006/R007/R008 — environment and repo hygiene rules.

R006 (subprocess env hygiene): a python child the package or a chip
script spawns (a map process, a serve worker, a mesh rank, a counted
child) must import THIS checkout's package: a bare checkout has no
installed package, so a child started in another directory with the
inherited environment finds no ``locust_tpu_torch``, or another copy of
it.  A spawn of python must
pass ``env=`` built with ``PYTHONPATH`` pinned.  (The card's host has no
jax, so the JAX package's ``JAX_PLATFORMS`` pin has nothing to pin
there.)  Heuristics: the command must visibly be python
(``sys.executable`` or a ``python`` literal in the argv expression, or a
local variable whose enclosing scope mentions ``sys.executable``); an
``env=`` forwarded from an enclosing function's parameter, or a field
of one, is trusted (the wrapper's callers own the pinning).

R007 (the chip script's last line): whoever runs ``chip_smoke.py`` reads
the LAST line of its stdout as one JSON object ``{"ok": true, ...}``.
Statically pinned as: exactly one ``print(json.dumps({"ok": ...}))``
site, and nothing after it in its function but a ``return`` — a call
after the last line (a log line, a report) would print behind it.

R008 (tracked artifact hygiene): ``__pycache__``/``*.pyc``/pytest caches
and built ``*.so`` libraries must never be tracked, and .gitignore must
keep ignoring them and the kernels' build directory (the top of
``_build.BUILD_DIR``).  Uses ``git ls-files`` (plain git, not python —
R006 does not apply) and skips silently when git is unavailable.
"""

from __future__ import annotations

import ast
import os
import re
import subprocess

from locust_tpu_torch.analysis.core import (
    Finding,
    Rule,
    call_name,
    parse_registry_module,
    unparse,
)

_SPAWN_ATTRS = {"run", "Popen", "call", "check_call", "check_output"}
_REQUIRED_ENV = ("PYTHONPATH",)


def _enclosing_function(tree: ast.Module, node: ast.AST):
    """Innermost def containing ``node`` (None = module level)."""
    best = None
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if (
                fn.lineno <= node.lineno
                and node.lineno <= max(
                    getattr(fn, "end_lineno", fn.lineno), fn.lineno
                )
                and (best is None or fn.lineno > best.lineno)
            ):
                best = fn
    return best


def _mentions_env_keys(scope: ast.AST) -> list[str]:
    """Which required env keys the scope visibly pins: string constants
    ("PYTHONPATH": ...) or keyword names (env.update(PYTHONPATH=...))."""
    found = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for key in _REQUIRED_ENV:
                if node.value == key:
                    found.add(key)
        elif isinstance(node, ast.keyword) and node.arg in _REQUIRED_ENV:
            found.add(node.arg)
    return [k for k in _REQUIRED_ENV if k in found]


def _is_python_spawn(call: ast.Call, scope: ast.AST) -> bool:
    if not call.args:
        return False
    argv = call.args[0]
    src = unparse(argv)
    if "sys.executable" in src or "python" in src.lower():
        return True
    if isinstance(argv, ast.Name) and scope is not None:
        return "sys.executable" in unparse(scope)
    return False


class SubprocessEnvRule(Rule):
    rule_id = "R006"
    title = "python child spawned without a pinned environment"

    def check_file(self, f, root):
        is_chip_script = "/" not in f.rel and f.rel.startswith("chip_")
        if not (f.rel.startswith(self.layout.prefix) or is_chip_script):
            return
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            leaf = func.attr if isinstance(func, ast.Attribute) else getattr(
                func, "id", None
            )
            if leaf not in _SPAWN_ATTRS:  # before the costly unparse
                continue
            callee = call_name(node)
            is_spawn = leaf == "Popen" or (
                leaf in _SPAWN_ATTRS and "subprocess" in callee
            )
            if not is_spawn:
                continue
            scope = _enclosing_function(f.tree, node) or f.tree
            if not _is_python_spawn(node, scope):
                continue
            env_kw = next(
                (kw for kw in node.keywords if kw.arg == "env"), None
            )
            if env_kw is None:
                yield Finding(
                    self.rule_id, f.rel, node.lineno, node.col_offset,
                    f"{callee} spawns python with the inherited "
                    "environment — a child started elsewhere may import "
                    "no package or another checkout's; pass env= pinning "
                    "PYTHONPATH to this checkout",
                )
                continue
            # env forwarded from a wrapper's parameter (or a field of
            # one, ``env=ctx.serve_env``): callers own it.
            base = env_kw.value
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name) and isinstance(
                scope, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                params = {
                    a.arg
                    for a in (
                        scope.args.args
                        + scope.args.kwonlyargs
                        + scope.args.posonlyargs
                    )
                }
                if base.id in params:
                    continue
            pinned = _mentions_env_keys(scope)
            missing = [k for k in _REQUIRED_ENV if k not in pinned]
            if missing:
                yield Finding(
                    self.rule_id, f.rel, node.lineno, node.col_offset,
                    f"{callee} spawns python with env= that never pins "
                    f"{' or '.join(missing)} in this scope — pin it so "
                    "the child imports this checkout's package",
                )


def _is_last_line(node: ast.AST) -> bool:
    """``print(json.dumps({"ok": ...}))``: the script's last line."""
    if not (isinstance(node, ast.Call) and call_name(node) == "print"):
        return False
    if not node.args or not isinstance(node.args[0], ast.Call):
        return False
    dump = node.args[0]
    if not call_name(dump).endswith("json.dumps") or not dump.args:
        return False
    obj = dump.args[0]
    return isinstance(obj, ast.Dict) and any(
        isinstance(k, ast.Constant) and k.value == "ok" for k in obj.keys
    )


def _statements_after(body: list, target: ast.AST) -> list | None:
    """Statements that run after the one holding ``target``, within the
    function holding it: its later siblings, then each enclosing
    block's (None when ``target`` is not in ``body``)."""
    for i, stmt in enumerate(body):
        if not any(n is target for n in ast.walk(stmt)):
            continue
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return _statements_after(stmt.body, target)
        later = list(body[i + 1:])
        blocks = [getattr(stmt, k, None) or []
                  for k in ("body", "orelse", "finalbody")]
        blocks += [h.body for h in getattr(stmt, "handlers", None) or []]
        for block in blocks:
            inner = _statements_after(block, target)
            if inner is not None:
                return inner + later
        return later
    return None


class BenchContractRule(Rule):
    rule_id = "R007"
    title = "chip_smoke.py last-line contract"

    script_rel = "chip_smoke.py"

    def check_file(self, f, root):
        if f.rel != self.script_rel:
            return
        sites = [n for n in ast.walk(f.tree) if _is_last_line(n)]
        if len(sites) != 1:
            where = sites[1] if len(sites) > 1 else None
            yield Finding(
                self.rule_id, f.rel,
                where.lineno if where is not None else 1,
                where.col_offset if where is not None else 0,
                f"{self.script_rel} must print its last line "
                '(print(json.dumps({"ok": ...}))) from exactly ONE site, '
                f"found {len(sites)} — its caller reads one last line "
                "from one place",
            )
        for site in sites:
            for stmt in _statements_after(f.tree.body, site) or []:
                if isinstance(stmt, ast.Return) and not any(
                    isinstance(n, ast.Call) for n in ast.walk(stmt)
                ):
                    continue
                yield Finding(
                    self.rule_id, f.rel, stmt.lineno, stmt.col_offset,
                    "statement after the last line's print "
                    f"(line {site.lineno}) — anything it prints lands "
                    "behind the line its caller parses; only a plain "
                    "return may follow",
                )
                break


_TRACKED_JUNK = re.compile(
    r"(^|/)__pycache__(/|$)|\.py[co]$|(^|/)\.pytest_cache(/|$)"
    r"|(^|/)\.hypothesis(/|$)|(^|/)\.DS_Store$|\.so$"
)
_IGNORE_WANTED = ("__pycache__/", "*.pyc", "*.so")


def _build_top(files, root: str, rel: str) -> str | None:
    """First directory under the repo of ``BUILD_DIR = <Path>/ "x" / ...``
    in the package's _build.py ("build"), None when unreadable."""
    tree = parse_registry_module(files, root, rel)
    if tree is None:
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "BUILD_DIR"
            for t in node.targets
        ):
            parts = []
            v = node.value
            while isinstance(v, ast.BinOp) and isinstance(v.op, ast.Div):
                if isinstance(v.right, ast.Constant) and isinstance(
                    v.right.value, str
                ):
                    parts.append(v.right.value)
                v = v.left
            return parts[-1] if parts else None
    return None


class TrackedArtifactRule(Rule):
    rule_id = "R008"
    title = "build/cache artifacts tracked by git"

    def check_project(self, files, root):
        if not os.path.isdir(os.path.join(root, ".git")):
            return  # fixture trees / exported sources: nothing to check
        try:
            out = subprocess.run(
                ["git", "-C", root, "ls-files"],
                capture_output=True, text=True, timeout=30,
            )
        except (OSError, subprocess.SubprocessError):
            return
        if out.returncode != 0:
            return
        for tracked in out.stdout.splitlines():
            if _TRACKED_JUNK.search(tracked):
                yield Finding(
                    self.rule_id, tracked, 1, 0,
                    "build/cache artifact is tracked by git — "
                    "`git rm -r --cached` it (and keep .gitignore "
                    "covering it)",
                )
        gi_path = os.path.join(root, ".gitignore")
        try:
            with open(gi_path, encoding="utf-8") as fh:
                entries = {ln.strip() for ln in fh}
        except OSError:
            entries = set()
        wanted = list(_IGNORE_WANTED)
        build_rel = self.layout.rel("_build.py")
        top = _build_top(files, root, build_rel)
        if top is None:
            yield Finding(
                self.rule_id, build_rel, 1, 0,
                "cannot read BUILD_DIR (module missing or no module-level "
                "`BUILD_DIR = ... / \"dir\" / ...` path) — the kernels' "
                "build directory cannot be verified as ignored",
            )
        elif not entries & {top, f"{top}/", f"/{top}", f"/{top}/"}:
            wanted.append(f"{top}/")
        for want in wanted:
            if want not in entries:
                yield Finding(
                    self.rule_id, ".gitignore", 1, 0,
                    f".gitignore is missing {want!r} — build and cache "
                    "artifacts will show up as untracked noise and "
                    "eventually get committed",
                )
