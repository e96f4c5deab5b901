"""R004/R005 — closed registries that must not drift.

R004 (fault-site consistency), in the spirit of lineage-driven fault
injection (Alvaro et al., 2015) and the two-sided CONFIG_AB_KINDS
readers: the ``faultplan.SITES`` registry, its hook call-sites, the
chaos suite and the docs must all agree —

  * every site string at a hook call-site (``faultplan.fire("x", ...)``,
    ``mangle``/``delay``/``damage_file``/``check_connect`` and the
    in-module ``_PLAN.fire``) must be a registered site;
  * every registered site must be HOOKED somewhere in the package (a
    registry entry with no call-site injects nothing, silently);
  * every registered site must appear in the package's suite (the
    ``Layout.tests`` glob, read as text: it is exercised) and in
    ``docs/FAULTS.md`` (it is documented).  The site names are the JAX
    package's by the wire and fault-plan contract, so one catalog
    documents both.

R005 (wire-constant drift): protocol magic bytes, versions and size
bounds have ONE defining module; a re-spelled literal elsewhere is a
fork waiting to disagree (``MAX_FRAME`` as ``64 * 1024 * 1024``, the
``b"\\x00LB"`` magic, serde's ``b"LKVB"``).  Constant expressions are
folded (``core.const_int``).  Attribution discipline: magic BYTES match
everywhere (they are distinctive), but int values match only inside the
wire layer itself (the package's ``distributor/``) — 8/32/64 MiB are round
numbers that legitimately recur as corpus/IO sizes elsewhere, and a
false wire-skew claim on a bench corpus size would teach people to
ignore the rule.
"""

from __future__ import annotations

import ast
import os

from locust_tpu_torch.analysis.core import Finding, Rule, call_name, const_int

FAULTS_DOCS_REL = "docs/FAULTS.md"

_HOOK_NAMES = {"fire", "mangle", "delay", "damage_file", "check_connect"}


def _parse_sites(files, root, rel) -> tuple[dict | None, int]:
    """The SITES dict literal from faultplan.py: {site: line} (+ def line).
    Reuses the phase-1 parse when faultplan is in the analyzed set (the
    one-parse-per-file economy)."""
    from locust_tpu_torch.analysis.core import parse_registry_module

    tree = parse_registry_module(files, root, rel)
    if tree is None:
        return None, 0
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "SITES"
                for t in node.targets
            )
            and isinstance(node.value, ast.Dict)
        ):
            sites = {}
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    sites[k.value] = k.lineno
            return sites, node.lineno
    return None, 0


class FaultSiteConsistencyRule(Rule):
    rule_id = "R004"
    title = "faultplan SITES registry drift"

    docs_rel = FAULTS_DOCS_REL

    def __init__(self, layout=None):
        super().__init__(layout)
        self.faultplan_rel = self.layout.rel("utils/faultplan.py")
        self.tests_rel = self.layout.tests

    def check_project(self, files, root):
        prefix = self.layout.prefix
        sites, sites_line = _parse_sites(files, root, self.faultplan_rel)
        if sites is None:
            yield Finding(
                self.rule_id, self.faultplan_rel, 1, 0,
                "cannot parse the SITES registry (module missing or no "
                "module-level `SITES = {...}` dict literal)",
            )
            return

        # Side 1: hook call-site strings must be registered sites.
        hooked: set[str] = set()
        for sf in files:
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                func = node.func
                attr = func.attr if isinstance(func, ast.Attribute) else (
                    func.id if isinstance(func, ast.Name) else None
                )
                if attr not in _HOOK_NAMES:
                    continue
                arg0 = node.args[0]
                if not (
                    isinstance(arg0, ast.Constant)
                    and isinstance(arg0.value, str)
                ):
                    continue
                site = arg0.value
                if "." not in site:  # e.g. str.replace("a", ...) lookalikes
                    continue
                if site not in sites:
                    yield Finding(
                        self.rule_id, sf.rel, node.lineno, node.col_offset,
                        f"fault hook {call_name(node)}({site!r}, ...) uses "
                        "a site not in faultplan.SITES — a typo'd site "
                        "injects nothing, silently",
                    )
                elif sf.rel.startswith(prefix):
                    hooked.add(site)

        # check_connect hardcodes rpc.connect inside faultplan itself;
        # callers of check_connect(host, port) exercise it without the
        # string, so count the site hooked if ANY call-site exists.
        if "rpc.connect" in sites and any(
            isinstance(node, ast.Call)
            and call_name(node).endswith("check_connect")
            for sf in files
            if sf.rel.startswith(prefix)
            for node in ast.walk(sf.tree)
        ):
            hooked.add("rpc.connect")

        def read(rel):
            try:
                with open(os.path.join(root, rel), encoding="utf-8") as f:
                    return f.read()
            except OSError:
                return None

        # The analyzer's own suite quotes phantom sites to test the
        # rule: those are not coverage (the R014/R015 exclusion).
        tests_text = self.layout.tests_text(root, exclude_analyzer=True)
        docs_text = read(self.docs_rel)

        # Side 2: every registered site is hooked, tested, documented.
        for site, line in sorted(sites.items()):
            if site not in hooked:
                yield Finding(
                    self.rule_id, self.faultplan_rel, line, 0,
                    f"SITES entry {site!r} has no hook call-site under "
                    f"{prefix} — a registered site that injects nothing",
                )
            if tests_text is None:
                yield Finding(
                    self.rule_id, self.tests_rel, 1, 0,
                    f"chaos suite {self.tests_rel} missing — SITES "
                    "entries cannot be verified as exercised",
                )
                tests_text = ""  # report the missing file once
            elif site not in tests_text:
                yield Finding(
                    self.rule_id, self.faultplan_rel, line, 0,
                    f"SITES entry {site!r} is never exercised in "
                    f"{self.tests_rel} — an untested fault site is an "
                    "untested recovery path",
                )
            if docs_text is None:
                yield Finding(
                    self.rule_id, self.docs_rel, 1, 0,
                    f"fault docs {self.docs_rel} missing — SITES entries "
                    "cannot be verified as documented",
                )
                docs_text = ""
            elif site not in docs_text:
                yield Finding(
                    self.rule_id, self.faultplan_rel, line, 0,
                    f"SITES entry {site!r} is undocumented in "
                    f"{self.docs_rel}",
                )


# name -> defining module (package-relative).  Ints below _INT_FLOOR are
# too common to attribute; bytes magics always match exactly.
WIRE_CONSTANTS = {
    "MAX_FRAME": "distributor/protocol.py",
    "FETCH_CHUNK": "distributor/protocol.py",
    "FETCH_CHUNK_MAX": "distributor/protocol.py",
    "BIN_MAGIC": "distributor/protocol.py",
    "BIN_VERSION": "distributor/protocol.py",
    "KVB_MAGIC": "io/serde.py",
    "KVB_VERSION": "io/serde.py",
}
_INT_FLOOR = 65536


def _defined_constants(files, root: str, layout) -> dict:
    """{name: (value, definer_rel)} for each wire constant we can read."""
    from locust_tpu_torch.analysis.core import parse_registry_module

    out = {}
    for name, sub in WIRE_CONSTANTS.items():
        rel = layout.rel(sub)
        tree = parse_registry_module(files, root, rel)
        if tree is None:
            continue
        for node in tree.body:
            if not isinstance(node, ast.Assign):
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets
            ):
                continue
            if (
                isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, bytes)
            ):
                out[name] = (node.value.value, rel)
            else:
                iv = const_int(node.value)
                if iv is not None:
                    out[name] = (iv, rel)
    return out


class WireConstantDriftRule(Rule):
    rule_id = "R005"
    title = "re-spelled wire constant"

    def check_project(self, files, root):
        consts = _defined_constants(files, root, self.layout)
        wire_layer = self.layout.rel("distributor/")
        by_bytes = {
            v: (n, rel) for n, (v, rel) in consts.items()
            if isinstance(v, bytes)
        }
        by_int = {
            v: (n, rel) for n, (v, rel) in consts.items()
            if isinstance(v, int) and v >= _INT_FLOOR
        }
        for sf in files:
            in_wire_layer = sf.rel.startswith(wire_layer)
            for node in ast.walk(sf.tree):
                hit = None
                if isinstance(node, ast.Constant) and isinstance(
                    node.value, bytes
                ):
                    hit = by_bytes.get(node.value)
                elif in_wire_layer and isinstance(
                    node, (ast.Constant, ast.BinOp)
                ):
                    iv = const_int(node)
                    if iv is not None:
                        hit = by_int.get(iv)
                # A definer may spell ITS OWN constants — but not another
                # module's (protocol.py re-spelling serde's KVB_MAGIC is
                # exactly the cross-module skew this rule exists for).
                if hit is None or hit[1] == sf.rel:
                    continue
                name, definer = hit
                yield Finding(
                    self.rule_id, sf.rel, node.lineno, node.col_offset,
                    f"literal re-spells {name} (defined once in "
                    f"{definer}) — import it; a fork of a wire constant "
                    "is a protocol skew waiting to disagree",
                )
