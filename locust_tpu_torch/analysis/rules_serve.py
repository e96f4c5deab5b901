"""R011 — serve error-code registry drift (two-sided, the R004/R009 mold).

The serve tier's whole error discipline is ONE closed registry
(the package's ``serve/jobs.py`` ``ERROR_CODES``): a client observes either
a correct result or a structured error whose ``code`` is a registry
entry — never a silent wrong answer (docs/SERVING.md).  The daemon took
ten review rounds to converge on exactly which codes exist
(``shutting_down`` vs queue_full at teardown, ``result_too_large`` for
the MAX_FRAME reply path, ``unknown_job`` guarding the invalidate
wipe-everything fallthrough); this rule keeps that converged state from
drifting, both directions:

  * every code EMITTED in the package's ``serve/`` — a literal first
    argument to ``structured_error(...)`` or ``AdmitReject(...)``, or
    the ``ValueError("code\\n...")`` first-line convention parse_spec
    uses — must be a registry entry (``structured_error`` raises at
    runtime, but only on paths something actually runs);
  * every registry entry must be emitted somewhere in serve/, documented
    in ``docs/SERVING.md``, and exercised by a literal mention in the
    package's suite (``Layout.tests``) — an unemitted code is a lie in the client's switch
    table, an untested one is an untested failure contract.

Dynamic codes (``structured_error(e.code, ...)`` relays) are skipped:
the convention is literal codes at origin sites, relays forward them.
"""

from __future__ import annotations

import ast
import os
import re

from locust_tpu_torch.analysis.core import Finding, Rule, call_name

SERVING_DOCS_REL = "docs/SERVING.md"

_CODE_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_EMIT_CALLS = {"structured_error", "AdmitReject"}


def _parse_error_codes(files, root, rel):
    """The ERROR_CODES tuple literal: {code: line} (None when absent)."""
    from locust_tpu_torch.analysis.core import parse_registry_module

    tree = parse_registry_module(files, root, rel)
    if tree is None:
        return None
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "ERROR_CODES"
                for t in node.targets
            )
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            codes = {}
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(
                    elt.value, str
                ):
                    codes[elt.value] = elt.lineno
            return codes
    return None


def _valueerror_code(call: ast.Call) -> str | None:
    """The ``ValueError("code\\nmessage")`` first-line convention: the
    literal prefix before the first newline, when it looks like a code.
    Covers plain strings and f-strings whose FIRST piece is the literal
    ``code\\n`` prefix (``f"bad_spec\\n{e}"``)."""
    if not call.args:
        return None
    arg = call.args[0]
    text = None
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        text = arg.value
    elif isinstance(arg, ast.JoinedStr) and arg.values:
        first = arg.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            text = first.value
    if text is None or "\n" not in text:
        return None
    prefix = text.split("\n", 1)[0]
    return prefix if _CODE_RE.match(prefix) else None


class ServeErrorRegistryRule(Rule):
    rule_id = "R011"
    title = "serve ERROR_CODES registry drift"

    docs_rel = SERVING_DOCS_REL

    def __init__(self, layout=None):
        super().__init__(layout)
        self.jobs_rel = self.layout.rel("serve/jobs.py")
        self.serve_prefix = self.layout.rel("serve/")

    def check_project(self, files, root):
        codes = _parse_error_codes(files, root, self.jobs_rel)
        if codes is None:
            yield Finding(
                self.rule_id, self.jobs_rel, 1, 0,
                "cannot parse the ERROR_CODES registry (module missing or "
                "no module-level `ERROR_CODES = (...)` tuple literal)",
            )
            return

        # Side 1: every literal code at an emission site is registered.
        emitted: set[str] = set()
        for sf in files:
            if not sf.rel.startswith(self.serve_prefix):
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                callee_leaf = call_name(node).split(".")[-1]
                code = None
                if callee_leaf in _EMIT_CALLS and node.args:
                    arg0 = node.args[0]
                    if isinstance(arg0, ast.Constant) and isinstance(
                        arg0.value, str
                    ):
                        code = arg0.value
                elif callee_leaf == "ValueError":
                    code = _valueerror_code(node)
                if code is None:
                    continue
                if code not in codes:
                    yield Finding(
                        self.rule_id, sf.rel, node.lineno, node.col_offset,
                        f"structured error code {code!r} is not in "
                        f"jobs.ERROR_CODES ({self.jobs_rel}) — a client "
                        "switching on the registry can never handle it",
                    )
                else:
                    emitted.add(code)

        def read(rel):
            try:
                with open(os.path.join(root, rel), encoding="utf-8") as f:
                    return f.read()
            except OSError:
                return None

        docs_text = read(self.docs_rel)
        # Minus the analyzer's own suite, whose fixtures quote phantom
        # codes (the R014/R015 exclusion).
        tests_text = self.layout.tests_text(root, exclude_analyzer=True) or ""
        if docs_text is None:
            # ONE finding for the missing file — per-code "undocumented"
            # findings against it would be N reports of one root cause.
            yield Finding(
                self.rule_id, self.docs_rel, 1, 0,
                f"serve docs {self.docs_rel} missing — ERROR_CODES "
                "entries cannot be verified as documented",
            )

        # Side 2: every registered code is emitted, documented, exercised.
        for code, line in sorted(codes.items()):
            if code not in emitted:
                yield Finding(
                    self.rule_id, self.jobs_rel, line, 0,
                    f"ERROR_CODES entry {code!r} is never emitted under "
                    f"{self.serve_prefix} — a registered reason code "
                    "nothing can raise is a lie in the client's switch "
                    "table",
                )
            if docs_text is not None and code not in docs_text:
                yield Finding(
                    self.rule_id, self.jobs_rel, line, 0,
                    f"ERROR_CODES entry {code!r} is undocumented in "
                    f"{self.docs_rel}",
                )
            if code not in tests_text:
                yield Finding(
                    self.rule_id, self.jobs_rel, line, 0,
                    f"ERROR_CODES entry {code!r} is never exercised under "
                    "tests/ — an untested reason code is an untested "
                    "failure contract",
                )
