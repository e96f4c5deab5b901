"""R009 — telemetry name-registry hygiene (two-sided, like R004/R005).

The obs subsystem's span/event/metric names live in ONE closed dict
(the package's ``obs/names.py`` ``NAMES``); the Tracer/Metrics validate
against it at runtime, but only on the ENABLED path — a typo'd name at a
call-site that nobody runs traced would record nothing, silently,
forever.  This rule closes the loop statically, both directions:

  * every literal name at an obs emission site — ``obs.span(...)``,
    ``obs.event(...)``, ``obs.metric_inc/metric_set/metric_observe(...)``
    — must exist in NAMES, with the kind the hook implies (a counter
    incremented as a histogram is the same drift one step subtler);
  * every registered name must be EMITTED somewhere in the package
    (a registry entry nothing emits is a timeline nobody can correlate —
    and a doc that lies).

Attribution discipline: only calls whose receiver is literally the
``obs`` module (``obs.span``/``....obs.event``) are claimed — a
``SpanTimer.span("load")`` or any other object's ``.event(...)`` must
never false-positive, which is also why the emission CONVENTION
(docs/OBSERVABILITY.md) is module-function calls with literal names.
"""

from __future__ import annotations

import ast

from locust_tpu_torch.analysis.core import Finding, Rule, unparse

# hook attribute -> the registry kind it emits.
_EMIT_KINDS = {
    "span": "span",
    "event": "event",
    "metric_inc": "counter",
    "metric_set": "gauge",
    "metric_observe": "histogram",
}


def _parse_names(files, root, rel) -> tuple[dict | None, int]:
    """The NAMES dict literal from obs/names.py: {name: (kind, line)}.
    Reuses the phase-1 parse (one-parse-per-file economy)."""
    from locust_tpu_torch.analysis.core import parse_registry_module

    tree = parse_registry_module(files, root, rel)
    if tree is None:
        return None, 0
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "NAMES"
                for t in node.targets
            )
            and isinstance(node.value, ast.Dict)
        ):
            names = {}
            for k, v in zip(node.value.keys, node.value.values):
                if (
                    isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                ):
                    names[k.value] = (v.value, k.lineno)
            return names, node.lineno
    return None, 0


class TelemetryRegistryRule(Rule):
    rule_id = "R009"
    title = "obs telemetry name-registry drift"

    def __init__(self, layout=None):
        super().__init__(layout)
        self.names_rel = self.layout.rel("obs/names.py")

    def check_project(self, files, root):
        prefix = self.layout.prefix
        names, _ = _parse_names(files, root, self.names_rel)
        if names is None:
            yield Finding(
                self.rule_id, self.names_rel, 1, 0,
                "cannot parse the NAMES registry (module missing or no "
                "module-level `NAMES = {...}` dict literal)",
            )
            return

        emitted: set[str] = set()
        for sf in files:
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                func = node.func
                if not isinstance(func, ast.Attribute):
                    continue
                kind = _EMIT_KINDS.get(func.attr)
                if kind is None:
                    continue
                base = unparse(func.value)
                if base != "obs" and not base.endswith(".obs"):
                    continue
                arg0 = node.args[0]
                if not (
                    isinstance(arg0, ast.Constant)
                    and isinstance(arg0.value, str)
                ):
                    # Dynamic names are the runtime validator's problem;
                    # the CONVENTION is literal names exactly so this
                    # rule sees everything (docs/OBSERVABILITY.md).
                    continue
                name = arg0.value
                if name not in names:
                    yield Finding(
                        self.rule_id, sf.rel, node.lineno, node.col_offset,
                        f"obs.{func.attr}({name!r}, ...) uses a name not "
                        "in the obs NAMES registry "
                        f"({self.names_rel}) — a typo'd telemetry name "
                        "records nothing the timeline can correlate",
                    )
                elif names[name][0] != kind:
                    yield Finding(
                        self.rule_id, sf.rel, node.lineno, node.col_offset,
                        f"obs.{func.attr} emits {name!r}, which the "
                        f"registry declares a {names[name][0]} (needs a "
                        f"{kind}) — kind drift between emitter and "
                        "registry",
                    )
                elif sf.rel.startswith(prefix):
                    emitted.add(name)

        for name, (kind, line) in sorted(names.items()):
            if name not in emitted:
                yield Finding(
                    self.rule_id, self.names_rel, line, 0,
                    f"NAMES entry {name!r} ({kind}) is never emitted "
                    f"under {prefix} — a registered telemetry name "
                    "nothing records is documentation drift",
                )
