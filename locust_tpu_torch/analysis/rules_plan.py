"""R014/R015 — plan registry drift (two-sided, the R004/R011 mold).

The plan layer's whole extensibility story is ONE closed registry
(the package's ``plan/nodes.py`` ``NODE_KINDS``): every dataflow node a
plan may use is an entry there, validation rejects anything else, and
``plan/compile.py`` must lower every entry (docs/PLAN.md).  ROADMAP
item 4's operators land as NEW KINDS in that registry — this rule keeps
both sides honest as they do:

  * every node-kind literal CONSTRUCTED or MATCHED in the package
    must be a registry entry — a typo'd kind at a construction site is a
    plan nothing can validate, and a matcher arm for an unregistered
    kind is dead code lying about coverage.  Recognized spellings (the
    convention ``plan/nodes.py`` establishes): ``node(id, "kind", ...)``
    / ``Node(kind="kind", ...)`` calls anywhere, and ``<expr>.kind ==
    "kind"`` / ``<expr>.kind in ("a", "b")`` comparisons inside the
    package's ``plan/`` (attribution discipline, like R005's
    int-in-wire-layer rule: ``.kind`` is a common attribute name —
    e.g. the analyzer's own thread summaries — so the comparison form
    only binds where the plan convention lives);
  * every registry entry must be LOWERED in ``plan/compile.py`` (its
    literal appears there), exercised under ``tests/`` (quoted), and
    documented in ``docs/PLAN.md`` (backticked) — a kind the compiler
    cannot lower is a validation-passes/dispatch-explodes trap, and an
    untested or undocumented kind is an unanchored contract;
  * every registry entry must be COVERED by the distributed planner:
    matched (``.kind`` comparison / constructed) in
    ``plan/distribute.py`` or explicitly listed in its ``SOLO_ONLY``
    registry — two-sided, so a new kind can never silently stay
    undistributed (the silent-solo-demotion bug class), and a stale
    ``SOLO_ONLY`` entry for a kind distribute.py now matches is flagged
    too.

R015 applies the same stance to the optimizer's ``REWRITE_RULES``
registry (the package's ``plan/optimize.py``): every
``record_rewrite("rule")`` literal in the package must be a
registry entry (a typo'd id already fails loudly at runtime — the
static half catches it before the firing path is ever reached), and
every entry must be APPLIED in ``plan/optimize.py`` (its literal
appears outside the registry tuple itself), exercised in the suite
(quoted) and documented in ``docs/PLAN.md`` (backticked) — a
registered rewrite nothing fires, tests or documents is a byte-identity
claim nobody is checking.
"""

from __future__ import annotations

import ast
import os

from locust_tpu_torch.analysis.core import Finding, Rule, call_name

PLAN_DOCS_REL = "docs/PLAN.md"

_CTOR_NAMES = {"node", "Node"}


def _parse_str_tuple(files, root, rel, name):
    """A module-level ``NAME = ("a", "b", ...)`` tuple literal (plain or
    annotated assignment): {entry: line}, {} for an EMPTY tuple (a valid
    registry), None when the module or assignment is absent."""
    from locust_tpu_torch.analysis.core import parse_registry_module

    tree = parse_registry_module(files, root, rel)
    if tree is None:
        return None
    for node in tree.body:
        value = None
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name
            for t in node.targets
        ):
            value = node.value
        elif (
            isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
            and node.target.id == name
        ):
            value = node.value
        if isinstance(value, (ast.Tuple, ast.List)):
            out = {}
            for elt in value.elts:
                if isinstance(elt, ast.Constant) and isinstance(
                    elt.value, str
                ):
                    out[elt.value] = elt.lineno
            return out
    return None


def _parse_kinds(files, root, rel):
    """The NODE_KINDS tuple literal: {kind: line} (None when absent)."""
    return _parse_str_tuple(files, root, rel, "NODE_KINDS")


def _ctor_kind(call: ast.Call) -> str | None:
    """The kind literal of a ``node("id", "kind", ...)`` /
    ``Node(kind="kind", ...)`` construction, or None."""
    leaf = call_name(call).split(".")[-1]
    if leaf not in _CTOR_NAMES:
        return None
    for kw in call.keywords:
        if kw.arg == "kind" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    if len(call.args) >= 2:
        arg = call.args[1]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
    return None


def _match_kinds(node: ast.Compare):
    """Kind literals of a ``<expr>.kind == "lit"`` / ``!=`` /
    ``in ("a", "b")`` comparison (empty list otherwise)."""
    left = node.left
    if not (isinstance(left, ast.Attribute) and left.attr == "kind"):
        return []
    if len(node.ops) != 1:
        return []
    cmp = node.comparators[0]
    if isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
        if isinstance(cmp, ast.Constant) and isinstance(cmp.value, str):
            return [cmp.value]
    elif isinstance(node.ops[0], (ast.In, ast.NotIn)):
        if isinstance(cmp, (ast.Tuple, ast.List, ast.Set)):
            return [
                e.value for e in cmp.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            ]
    return []


class PlanRegistryRule(Rule):
    rule_id = "R014"
    title = "plan NODE_KINDS registry drift"

    docs_rel = PLAN_DOCS_REL

    def __init__(self, layout=None):
        super().__init__(layout)
        self.nodes_rel = self.layout.rel("plan/nodes.py")
        self.compile_rel = self.layout.rel("plan/compile.py")
        self.distribute_rel = self.layout.rel("plan/distribute.py")

    def check_project(self, files, root):
        kinds = _parse_kinds(files, root, self.nodes_rel)
        if kinds is None:
            yield Finding(
                self.rule_id, self.nodes_rel, 1, 0,
                "cannot parse the NODE_KINDS registry (module missing or "
                "no module-level `NODE_KINDS = (...)` tuple literal)",
            )
            return

        plan_prefix = os.path.dirname(self.nodes_rel) + "/"

        # Side 1: every constructed/matched kind literal is registered.
        # The same walk collects distribute.py's matched kinds as side
        # 3's coverage evidence (matcher arms + constructions there).
        compile_literals: set[str] = set()
        distribute_matched: set[str] = set()
        for sf in files:
            in_locust = sf.rel.startswith(self.layout.prefix)
            if sf.rel == self.compile_rel:
                for node in ast.walk(sf.tree):
                    if isinstance(node, ast.Constant) and isinstance(
                        node.value, str
                    ):
                        compile_literals.add(node.value)
            if not in_locust or sf.rel == self.nodes_rel:
                # The registry module defines the kinds; re-reporting
                # its own literals would flag the registry itself.
                continue
            for node in ast.walk(sf.tree):
                found = []
                if isinstance(node, ast.Call):
                    k = _ctor_kind(node)
                    if k is not None:
                        found = [k]
                elif isinstance(node, ast.Compare) and sf.rel.startswith(
                    plan_prefix
                ):
                    found = _match_kinds(node)
                if found and sf.rel == self.distribute_rel:
                    distribute_matched.update(found)
                for k in found:
                    if k not in kinds:
                        yield Finding(
                            self.rule_id, sf.rel, node.lineno,
                            node.col_offset,
                            f"plan node kind {k!r} is not in "
                            f"NODE_KINDS ({self.nodes_rel}) — a typo'd "
                            "kind is a plan nothing can validate",
                        )

        def read(rel):
            try:
                with open(os.path.join(root, rel), encoding="utf-8") as f:
                    return f.read()
            except OSError:
                return None

        docs_text = read(self.docs_rel)
        # The analyzer's OWN suite is excluded from the exercised-scan:
        # its R014 fixtures quote phantom kinds ("window", ...) to test
        # the RULE, and counting those as coverage would let a real
        # future kind with that name pass the untested check forever.
        tests_text = self.layout.tests_text(root, exclude_analyzer=True) or ""
        if docs_text is None:
            yield Finding(
                self.rule_id, self.docs_rel, 1, 0,
                f"plan docs {self.docs_rel} missing — NODE_KINDS entries "
                "cannot be verified as documented",
            )

        # Side 2: every registered kind is lowered, exercised, documented.
        for kind, line in sorted(kinds.items()):
            if kind not in compile_literals:
                yield Finding(
                    self.rule_id, self.nodes_rel, line, 0,
                    f"NODE_KINDS entry {kind!r} is never lowered in "
                    f"{self.compile_rel} — a kind validation admits but "
                    "the compiler cannot execute is a dispatch-time trap",
                )
            if f'"{kind}"' not in tests_text:
                yield Finding(
                    self.rule_id, self.nodes_rel, line, 0,
                    f"NODE_KINDS entry {kind!r} is never exercised under "
                    "tests/ — an untested node kind is an untested "
                    "dataflow contract",
                )
            if docs_text is not None and f"`{kind}`" not in docs_text:
                yield Finding(
                    self.rule_id, self.nodes_rel, line, 0,
                    f"NODE_KINDS entry {kind!r} is undocumented in "
                    f"{self.docs_rel} (backtick the kind in the node "
                    "catalog)",
                )

        # Side 3: distributed coverage, two-sided.  Every kind either
        # participates in a distributed shape (matched in
        # plan/distribute.py) or is explicitly distribution-exempt in
        # its SOLO_ONLY registry — and an exemption for a kind
        # distribute.py matches is stale and flagged.
        solo_only = _parse_str_tuple(
            files, root, self.distribute_rel, "SOLO_ONLY"
        )
        if solo_only is None:
            yield Finding(
                self.rule_id, self.distribute_rel, 1, 0,
                "cannot parse the SOLO_ONLY registry (module missing or "
                "no module-level `SOLO_ONLY = (...)` tuple literal) — "
                "distributed coverage of NODE_KINDS cannot be verified",
            )
            return
        for k, line in sorted(solo_only.items()):
            if k not in kinds:
                yield Finding(
                    self.rule_id, self.distribute_rel, line, 0,
                    f"SOLO_ONLY entry {k!r} is not a NODE_KINDS entry "
                    f"({self.nodes_rel}) — an exemption for a kind that "
                    "does not exist hides a typo",
                )
            elif k in distribute_matched:
                yield Finding(
                    self.rule_id, self.distribute_rel, line, 0,
                    f"SOLO_ONLY entry {k!r} is matched in "
                    f"{self.distribute_rel} — the exemption is stale; "
                    "drop it so the coverage claim stays honest",
                )
        for kind, line in sorted(kinds.items()):
            if kind not in distribute_matched and kind not in solo_only:
                yield Finding(
                    self.rule_id, self.nodes_rel, line, 0,
                    f"NODE_KINDS entry {kind!r} is neither matched in "
                    f"{self.distribute_rel} nor registered SOLO_ONLY "
                    "there — a new kind must either join a distributed "
                    "shape or declare itself solo-only, never silently "
                    "stay undistributed",
                )


def _parse_rewrite_rules(files, root, rel):
    """The REWRITE_RULES tuple literal: ``({rule: line}, (lo, hi))``
    where (lo, hi) is the assignment's own line span (its literals are
    the registry, not applied-side evidence), or ``(None, None)``."""
    from locust_tpu_torch.analysis.core import parse_registry_module

    tree = parse_registry_module(files, root, rel)
    if tree is None:
        return None, None
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "REWRITE_RULES"
                for t in node.targets
            )
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            rules = {}
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(
                    elt.value, str
                ):
                    rules[elt.value] = elt.lineno
            return rules, (node.lineno, node.end_lineno or node.lineno)
    return None, None


class RewriteRegistryRule(Rule):
    rule_id = "R015"
    title = "plan REWRITE_RULES registry drift"

    docs_rel = PLAN_DOCS_REL

    def __init__(self, layout=None):
        super().__init__(layout)
        self.optimize_rel = self.layout.rel("plan/optimize.py")

    def check_project(self, files, root):
        rules, span = _parse_rewrite_rules(files, root, self.optimize_rel)
        if rules is None:
            yield Finding(
                self.rule_id, self.optimize_rel, 1, 0,
                "cannot parse the REWRITE_RULES registry (module missing "
                "or no module-level `REWRITE_RULES = (...)` tuple "
                "literal)",
            )
            return

        # Side 1: every record_rewrite("lit") in the package is a
        # registry entry.  The optimize module's own string constants
        # OUTSIDE the registry assignment double as the applied-side
        # evidence for side 2 (exact whole-string match — docstrings
        # don't count, a rule id embedded in prose is not an
        # application site).
        applied_literals: set[str] = set()
        for sf in files:
            if sf.rel == self.optimize_rel:
                for node in ast.walk(sf.tree):
                    if (
                        isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and not (span[0] <= node.lineno <= span[1])
                    ):
                        applied_literals.add(node.value)
            if not sf.rel.startswith(self.layout.prefix):
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                if call_name(node).split(".")[-1] != "record_rewrite":
                    continue
                if (
                    node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    r = node.args[0].value
                    if r not in rules:
                        yield Finding(
                            self.rule_id, sf.rel, node.lineno,
                            node.col_offset,
                            f"rewrite rule {r!r} is not in REWRITE_RULES "
                            f"({self.optimize_rel}) — an unregistered id "
                            "fails loudly at the firing site; register it",
                        )

        def read(rel):
            try:
                with open(os.path.join(root, rel), encoding="utf-8") as f:
                    return f.read()
            except OSError:
                return None

        docs_text = read(self.docs_rel)
        # Same exclusion as R014: the analyzer's own suite quotes
        # phantom rule ids to test the RULE — those are not coverage.
        tests_text = self.layout.tests_text(root, exclude_analyzer=True) or ""
        if docs_text is None:
            yield Finding(
                self.rule_id, self.docs_rel, 1, 0,
                f"plan docs {self.docs_rel} missing — REWRITE_RULES "
                "entries cannot be verified as documented",
            )

        # Side 2: every registered rule is applied, exercised, documented.
        for rule, line in sorted(rules.items()):
            if rule not in applied_literals:
                yield Finding(
                    self.rule_id, self.optimize_rel, line, 0,
                    f"REWRITE_RULES entry {rule!r} is never applied in "
                    f"{self.optimize_rel} — a registered rewrite nothing "
                    "fires is a dead contract",
                )
            if f'"{rule}"' not in tests_text:
                yield Finding(
                    self.rule_id, self.optimize_rel, line, 0,
                    f"REWRITE_RULES entry {rule!r} is never exercised "
                    "under tests/ — an untested rewrite is an untested "
                    "byte-identity claim",
                )
            if docs_text is not None and f"`{rule}`" not in docs_text:
                yield Finding(
                    self.rule_id, self.optimize_rel, line, 0,
                    f"REWRITE_RULES entry {rule!r} is undocumented in "
                    f"{self.docs_rel} (backtick the rule in the "
                    "Optimizer section)",
                )
