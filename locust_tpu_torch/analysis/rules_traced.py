"""R003 — host syncs inside loops in the package's library code.

Every read of a device tensor's value on the host — ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``int``/``bool``/``float`` of a
reduction (``int(t.sum())``) — and every explicit wait —
``torch.cuda.synchronize()``, ``Event.synchronize()`` — blocks the host
until the card has drained its queue.  Inside a ``for``/``while`` loop
that serializes the pipeline once per iteration, the cost the JAX
package's fused ``lax.scan`` engine exists to avoid (its R003 flags
``block_until_ready``/``jax.device_get`` the same way).

The port's loops mostly reach their syncs through a helper (the
streaming loop's ``dispatch``, the engine's ``_sync``, the hasht fold's
ladder), so the rule follows each call made inside a loop through the
summaries call graph, ``hops`` calls deep, and reports the sync where it
is written.  Reads the port means to make (the unresolved-count read per
hasht fold, the flag read per block or segment under ``fused``, timing
boundaries, backpressure) carry a ``# locust: noqa[R003] <reason>``
naming the JAX counterpart line where there is one.

Attribution limits: the receiver's type is unknown, so a ``.tolist()``
of a numpy array in a loop is flagged as well (a host-only read takes a
reason-noqa).  A conversion of a plain name (``bool(flag)``) is a read
only when the function binds that name from a torch call or a call the
graph resolves into the package; a tensor that arrives as a parameter
or through an unresolved call (``self.map_fn(...)``) is not seen.

R002 (traced purity) and R010 (donated buffers) of the catalog have no
subject here: nothing in the package is traced or donated
(``registry.ABSENT``).
"""

from __future__ import annotations

import ast

from locust_tpu_torch.analysis.core import Finding, Rule, call_name

_READ_ATTRS = {"item", "tolist", "cpu", "numpy"}
_CONVERSIONS = {"int", "bool", "float"}
_REDUCTIONS = {"sum", "any", "all", "max", "min", "count_nonzero"}


def _short(call: ast.Call) -> str:
    """``torch.cuda.synchronize`` / ``ev.synchronize``, or ``<expr>.cpu``
    when the receiver is itself a computed value."""
    func = call.func
    if isinstance(func, ast.Attribute) and not isinstance(
        func.value, (ast.Name, ast.Attribute)
    ):
        return f"<expr>.{func.attr}"
    return call_name(call)


def sync_form(call: ast.Call, tensors: frozenset = frozenset()) -> str | None:
    """Text naming the read when ``call`` blocks the host on the card.
    ``tensors``: names the enclosing function binds from a torch call
    or a call into the package (``flag`` of ``..., flag =
    fused_block_preagg(...)``), whose ``bool``/``int``/``float`` is a
    host read as well."""
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr == "synchronize" or (
            func.attr in _READ_ATTRS and not call.args
        ):
            return f"{_short(call)}()"
    elif (
        isinstance(func, ast.Name)
        and func.id in _CONVERSIONS
        and len(call.args) == 1
    ):
        arg = call.args[0]
        if isinstance(arg, ast.Name) and arg.id in tensors:
            return f"{func.id}({arg.id})"
        if isinstance(arg, ast.Call):
            inner = call_name(arg)
            if inner.startswith("torch.") or inner.split(".")[-1] in _REDUCTIONS:
                return f"{func.id}({_short(arg)}(...))"
    return None


def _loops(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, (ast.For, ast.AsyncFor, ast.While)):
            yield n


def _per_iteration(loop) -> list:
    """The parts of a loop that run once per iteration: the body, and a
    ``while`` loop's test (a ``for`` loop's iterable and its ``else``
    run once)."""
    parts = list(loop.body)
    if isinstance(loop, ast.While):
        parts.append(loop.test)
    return parts


class HostSyncInLoopRule(Rule):
    rule_id = "R003"
    title = "host sync inside a hot loop"

    hops = 4

    def check_program(self, program):
        self._tensor_memo: dict[int, frozenset] = {}
        emitted: set[tuple] = set()
        for mod in program.modules.values():
            # Library code only: tests and scripts sync at will.
            if not mod.rel.startswith(self.layout.prefix):
                continue
            if "import torch" not in mod.sf.text:
                continue
            seen: set[int] = set()  # nested loops and defs: each call once
            for fn in mod.functions:  # outer defs first: they see closures
                tensors = self._tensors(program, fn)
                for loop in _loops(fn.node):
                    for node in (n for part in _per_iteration(loop)
                                 for n in ast.walk(part)):
                        if not isinstance(node, ast.Call) or id(node) in seen:
                            continue
                        seen.add(id(node))
                        what = sync_form(node, tensors)
                        if what is None:
                            yield from self._follow(
                                program, mod, node, loop, emitted
                            )
                            continue
                        key = (mod.rel, node.lineno, node.col_offset)
                        if key not in emitted:
                            emitted.add(key)
                            yield Finding(
                                self.rule_id, mod.rel, node.lineno,
                                node.col_offset,
                                f"host sync ({what}) inside a loop blocks "
                                "the host on the card once per iteration "
                                "— hoist it, batch the reads into one, or "
                                "noqa with the reason the read is needed",
                            )

    def _tensors(self, program, fn) -> frozenset:
        """Names ``fn`` (its nested defs included) binds from a torch
        call or a call the graph resolves into the package."""
        key = id(fn.node)
        if key not in self._tensor_memo:
            names = set()
            for n in ast.walk(fn.node):
                if not (isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Call)):
                    continue
                callee = call_name(n.value)
                if not (callee.startswith("torch.")
                        or program.graph.resolve(fn.module, callee)):
                    continue
                for t in n.targets:
                    for e in t.elts if isinstance(t, ast.Tuple) else [t]:
                        if isinstance(e, ast.Name):
                            names.add(e.id)
            self._tensor_memo[key] = frozenset(names)
        return self._tensor_memo[key]

    def _follow(self, program, mod, call, loop, emitted):
        frontier = program.graph.resolve(
            mod, call_name(call), include_nested=True
        )
        chain = {id(fn.node): (fn.name,) for fn in frontier}
        for _ in range(self.hops):
            nxt = []
            for fn in frontier:
                if fn.module.rel.startswith(self.layout.prefix) and (
                    "import torch" in fn.module.sf.text
                ):
                    yield from self._report(program, fn, chain[id(fn.node)],
                                            mod, loop, emitted)
                for c in fn.calls:
                    for t in program.graph.resolve(fn.module, c.callee):
                        if id(t.node) not in chain:
                            chain[id(t.node)] = chain[id(fn.node)] + (
                                t.name,
                            )
                            nxt.append(t)
            frontier = nxt
            if not frontier:
                break

    def _report(self, program, fn, path, mod, loop, emitted):
        tensors = self._tensors(program, fn)
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            what = sync_form(node, tensors)
            if what is None:
                continue
            key = (fn.rel, node.lineno, node.col_offset)
            if key in emitted:
                continue
            emitted.add(key)
            yield Finding(
                self.rule_id, fn.rel, node.lineno, node.col_offset,
                f"host sync ({what}) in '{fn.name}', called from the loop "
                f"at {mod.rel}:{loop.lineno} via {' -> '.join(path)}, "
                "blocks the host on the card once per iteration — hoist "
                "it, batch the reads into one, or noqa with the reason "
                "the read is needed",
            )
