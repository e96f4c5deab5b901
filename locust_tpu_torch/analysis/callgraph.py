"""Cross-module call resolution over the phase-1 summaries.

The graph is deliberately narrow — a call is followed only when its
callee can be ATTRIBUTED, in the same false-negative-leaning spirit as
every other rule (docs/ANALYSIS.md):

  * a bare name resolves to same-module top-level defs first, then
    through the module's imports (``from locust_tpu.x import fn``);
  * ``self.meth`` / ``cls.meth`` resolves to same-module defs named
    ``meth`` (classes are not modeled — the module is the unit);
  * ``mod.fn`` resolves through ``import``/``from ... import mod`` when
    ``mod`` names an analyzed module; ``Cls.meth`` resolves when ``Cls``
    was imported from an analyzed module;
  * anything else — ``obj.meth`` on an arbitrary receiver, calls through
    parameters or containers — is UNRESOLVED and silently skipped.

Only top-level functions and methods are returned: a def nested inside a
function is either covered by its parent's whole-subtree summary or
unreachable by name from outside.
"""

from __future__ import annotations

import ast


def module_imports(
    tree: ast.Module, self_name: str, is_package: bool = False
) -> dict[str, str]:
    """Local binding -> dotted target for every import in the module:
    ``import a.b as c`` -> {"c": "a.b"}; ``import a.b`` -> {"a": "a"};
    ``from a.b import x as y`` -> {"y": "a.b.x"}.  Relative imports are
    anchored on the module's own package — for a package ``__init__``
    (``is_package``) level 1 is the package ITSELF, not its parent."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    out[root] = root
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = self_name.split(".")
                drop = node.level - (1 if is_package else 0)
                anchor = parts[: max(0, len(parts) - drop)]
                base = ".".join(anchor + ([base] if base else []))
            for a in node.names:
                if a.name == "*":
                    continue
                target = f"{base}.{a.name}" if base else a.name
                out[a.asname or a.name] = target
    return out


class CallGraph:
    def __init__(self, program):
        self.program = program

    def resolve(self, mod, callee: str, include_nested: bool = False):
        """Callee source text -> list of FunctionSummary targets (empty
        when unresolvable).  ``include_nested`` widens same-module bare /
        ``self.``-resolution to nested defs — thread ENTRY points may be
        nested (``Thread(target=attempt)``); followed CALLS never are."""
        parts = callee.split(".")
        table = mod.by_name if include_nested else mod.top_by_name
        if len(parts) == 1:
            hits = table.get(parts[0])
            if hits:
                return hits
            return self._imported(mod, parts[0])
        if parts[0] in ("self", "cls") and len(parts) == 2:
            return table.get(parts[1], [])
        # Dotted path: substitute the head through the imports, then try
        # "<module>.fn" and "<module>.Cls.meth" splits.
        head = mod.imports.get(parts[0], parts[0])
        fparts = head.split(".") + parts[1:]
        for cut in (1, 2):
            if len(fparts) <= cut:
                break
            target_mod = self.program.modules.get(".".join(fparts[:-cut]))
            if target_mod is not None:
                return target_mod.top_by_name.get(fparts[-1], [])
        return []

    def _imported(self, mod, name: str):
        target = mod.imports.get(name)
        if not target:
            return []
        owner, _, attr = target.rpartition(".")
        target_mod = self.program.modules.get(owner)
        if target_mod is None:
            return []
        return target_mod.top_by_name.get(attr, [])
