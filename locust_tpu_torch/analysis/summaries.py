"""Phase 1 of the two-phase engine: whole-program effect summaries.

Every configured file is parsed exactly once (``core.load_files``); this
module walks those trees ONCE more and distills, per module and per
function, the facts the interprocedural rules re-run over in phase 2
(docs/ANALYSIS.md):

  * **writes** — ``self.*``/``global``/own-``nonlocal`` assignments, each
    tagged with whether a ``with <lock>:`` encloses it locally (the
    Eraser-style lockset fact R001 propagates through call chains);
  * **calls** — every call with its dotted callee text and the same
    local lock context (the edges of the cross-module call graph);
  * **thread entries** — where threads enter;
  * **lifecycle facts** — threads/executors spawned, daemonized, joined
    or shut down (R012);
  * **module constants** — top-level string and tuple-of-string
    assignments (``EPOCH_KEY = "_epoch"``, ``COMMANDS = (...)``) so the
    message-flow pass (rpcflow.py, R016/R018) resolves wire-key
    spellings and command registries without re-walking any tree.

Summaries keep the parsed AST nodes (no re-parse, no source copies); the
``Program`` object owns the module table and the import-resolved call
graph (callgraph.py).  Like the whole analyzer this imports none of the
checked code, no torch and no jax.
"""

from __future__ import annotations

import ast
import dataclasses

from locust_tpu_torch.analysis.callgraph import CallGraph, module_imports
from locust_tpu_torch.analysis.core import call_name, unparse

_LOCKISH = ("lock", "mutex", "semaphore", "cond")


def is_lock_ctx(item: ast.withitem) -> bool:
    src = unparse(item.context_expr).lower()
    return any(word in src for word in _LOCKISH)


def module_name(rel: str) -> str:
    """Repo-relative path -> dotted module name ("chip_smoke.py" -> "chip_smoke",
    "locust_tpu_torch/obs/__init__.py" -> "locust_tpu_torch.obs")."""
    name = rel[:-3] if rel.endswith(".py") else rel
    if name.endswith("/__init__"):
        name = name[: -len("/__init__")]
    return name.replace("/", ".")


@dataclasses.dataclass
class WriteFact:
    line: int
    col: int
    desc: str      # "self.state" / "total"
    locked: bool   # a `with <lock>:` encloses the write locally


@dataclasses.dataclass
class CallFact:
    line: int
    col: int
    callee: str    # dotted source text of the callee ("self._handle")
    locked: bool
    node: ast.Call


@dataclasses.dataclass
class SpawnFact:
    kind: str          # "thread" | "executor"
    line: int
    col: int
    bound: str | None  # dotted target text when assigned, else None
    daemon: bool       # daemon=True at the constructor
    in_with: bool      # executor used as a `with` context (auto-shutdown)
    chained_start: bool  # Thread(...).start() with no binding


class FunctionSummary:
    """One def/async def (or an entry lambda): its shared-state writes
    and outgoing calls, each with local lock context.
    Facts cover the WHOLE subtree including nested defs (the entry
    function's view of its closure, matching the single-pass engine);
    the call graph therefore never follows a call into a callee nested
    inside the caller — those lines were already scanned."""

    def __init__(self, node, module: "ModuleSummary", nested: bool):
        self.node = node
        self.module = module
        self.rel = module.rel
        self.name = getattr(node, "name", "<lambda>")
        self.lineno = node.lineno
        self.nested = nested
        self.writes: list[WriteFact] = []
        self.calls: list[CallFact] = []
        self._scan()

    # ------------------------------------------------------------- scanning

    def _scan(self) -> None:
        shared = _declared_shared(self.node)
        body = self.node.body
        for stmt in body if isinstance(body, list) else [body]:
            self._visit(stmt, shared, locked=False)

    def _visit(self, node: ast.AST, shared: set[str], locked: bool) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = locked or any(is_lock_ctx(i) for i in node.items)
            for child in ast.iter_child_nodes(node):
                self._visit(child, shared, inner)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                desc = _shared_target(t, shared)
                if desc:
                    self.writes.append(
                        WriteFact(node.lineno, node.col_offset, desc, locked)
                    )
        elif isinstance(node, ast.Call):
            callee = call_name(node)
            if callee:
                self.calls.append(
                    CallFact(node.lineno, node.col_offset, callee,
                             locked, node)
                )
        for child in ast.iter_child_nodes(node):
            self._visit(child, shared, locked)


def _shared_target(t: ast.AST, shared: set[str]) -> str | None:
    root = t
    while isinstance(root, ast.Subscript):
        root = root.value
    if isinstance(root, ast.Attribute):
        base = root.value
        if isinstance(base, ast.Name) and base.id == "self":
            return f"self.{root.attr}"
    if isinstance(root, ast.Name) and root.id in shared:
        return root.id
    return None


def _declared_shared(fn: ast.AST) -> set[str]:
    """Names ``fn`` shares beyond its own frame: ``global`` anywhere in
    its subtree, ``nonlocal`` only when declared BY ``fn`` itself (a
    nested def's nonlocal refers to this function's own locals, which
    are private to its thread).  One traversal, tracking nesting depth
    (this runs per function; two subtree walks here dominated the
    summaries build)."""
    names: set[str] = set()
    stack: list[tuple[ast.AST, bool]] = [(fn, False)]
    first = True
    while stack:
        node, nested = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and not first:
            nested = True
        first = False
        if isinstance(node, ast.Global):
            names.update(node.names)
        elif isinstance(node, ast.Nonlocal) and not nested:
            names.update(node.names)
        stack.extend((c, nested) for c in ast.iter_child_nodes(node))
    return names


# --------------------------------------------------------- module summaries


def _thread_entries(nodes: list):
    """(expr, how) for every function reference handed to a thread.
    ``nodes`` is the module's shared pre-walked node list — these
    module-level scans used to each re-walk the tree, and the repeated
    traversal (not the matching) was the summaries-build hot spot."""
    executors = _executor_names(nodes)
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        callee = call_name(node)
        if callee.split(".")[-1] == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    yield kw.value, "threading.Thread target"
        elif isinstance(node.func, ast.Attribute):
            owner = node.func.value
            owner_name = owner.id if isinstance(owner, ast.Name) else None
            if node.func.attr == "submit" and node.args:
                yield node.args[0], "executor.submit callable"
            elif (
                node.func.attr == "map"
                and node.args
                and owner_name in executors
            ):
                yield node.args[0], "executor.map callable"


def _executor_names(nodes: list) -> set[str]:
    names: set[str] = set()
    for node in nodes:
        if isinstance(node, ast.withitem):
            ctx, opt = node.context_expr, node.optional_vars
            if (
                isinstance(ctx, ast.Call)
                and "Executor" in call_name(ctx)
                and isinstance(opt, ast.Name)
            ):
                names.add(opt.id)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if "Executor" in call_name(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def _spawns(nodes: list):
    """Thread/executor lifecycle facts for R012."""
    bound: dict[int, str] = {}  # id(call node) -> dotted target text
    with_ctx: set[int] = set()
    joined: set[str] = set()
    shutdown: set[str] = set()
    daemon_after: set[str] = set()  # `t.daemon = True` after construction
    for node in nodes:
        if isinstance(node, ast.Assign):
            if isinstance(node.value, ast.Call):
                for t in node.targets:
                    if isinstance(t, (ast.Name, ast.Attribute)):
                        bound[id(node.value)] = unparse(t)
            if (
                isinstance(node.value, ast.Constant)
                and node.value.value is True
            ):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr == "daemon":
                        daemon_after.add(unparse(t.value))
        elif isinstance(node, ast.withitem):
            with_ctx.add(id(node.context_expr))
        elif isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            if node.func.attr == "join":
                joined.add(unparse(node.func.value))
            elif node.func.attr == "shutdown":
                shutdown.add(unparse(node.func.value))

    spawns: list[SpawnFact] = []
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        callee = call_name(node)
        leaf = callee.split(".")[-1]
        if leaf == "Thread":
            daemon = any(
                kw.arg == "daemon"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in node.keywords
            )
            name = bound.get(id(node))
            spawns.append(SpawnFact(
                "thread", node.lineno, node.col_offset, name,
                daemon or (name in daemon_after if name else False),
                in_with=False, chained_start=False,
            ))
        elif "Executor" in leaf:
            spawns.append(SpawnFact(
                "executor", node.lineno, node.col_offset,
                bound.get(id(node)), daemon=False,
                in_with=id(node) in with_ctx, chained_start=False,
            ))
    # Thread(...).start() with no binding: the call node is the .start
    # attribute's receiver.
    for node in nodes:
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "start"
            and isinstance(node.func.value, ast.Call)
        ):
            inner = node.func.value
            for s in spawns:
                if (s.line, s.col) == (inner.lineno, inner.col_offset):
                    s.chained_start = True
    return spawns, joined, shutdown


def _const_str_seq(v: ast.AST) -> tuple | None:
    """A tuple/list/set of string constants (command registries are
    spelled this way), following ``+`` concatenation of resolvable
    halves."""
    if isinstance(v, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for e in v.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return tuple(out)
    if isinstance(v, ast.BinOp) and isinstance(v.op, ast.Add):
        left = _const_str_seq(v.left)
        right = _const_str_seq(v.right)
        if left is not None and right is not None:
            return left + right
    return None


def _module_consts(tree: ast.Module):
    """Top-level ``NAME = "str"`` and ``NAME = ("a", "b", ...)`` tables —
    the wire-key constants (protocol.EPOCH_KEY) and command registries
    the rpcflow pass resolves spellings through (R016/R018)."""
    strs: dict[str, str] = {}
    seqs: dict[str, tuple] = {}
    for stmt in tree.body:
        if not (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
        ):
            continue
        name, v = stmt.targets[0].id, stmt.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            strs[name] = v.value
        else:
            items = _const_str_seq(v)
            if items is not None:
                seqs[name] = items
    return strs, seqs


class ModuleSummary:
    def __init__(self, sf):
        self.sf = sf
        self.rel = sf.rel
        self.name = module_name(sf.rel)
        tree = sf.tree
        self.imports = module_imports(
            tree, self.name, is_package=sf.rel.endswith("/__init__.py")
        )
        self.functions: list[FunctionSummary] = []
        self.by_name: dict[str, list[FunctionSummary]] = {}
        self.top_by_name: dict[str, list[FunctionSummary]] = {}
        self._collect(tree, nested=False)
        # One walk, shared by every module-level scan below: re-walking
        # the tree per scan (not the matching) was the build hot spot.
        nodes = list(ast.walk(tree))
        self.thread_entries = list(_thread_entries(nodes))
        self.spawns, self.joined, self.shutdown = _spawns(nodes)
        self.str_consts, self.seq_consts = _module_consts(tree)

    def _collect(self, node: ast.AST, nested: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fsum = FunctionSummary(child, self, nested)
                self.functions.append(fsum)
                self.by_name.setdefault(child.name, []).append(fsum)
                if not nested:
                    self.top_by_name.setdefault(child.name, []).append(fsum)
                self._collect(child, nested=True)
            else:
                self._collect(child, nested)

    def lambda_summary(self, node: ast.Lambda) -> FunctionSummary:
        """Ad-hoc summary for an entry lambda (writes are impossible in a
        lambda body; its calls are what following needs)."""
        return FunctionSummary(node, self, nested=True)


class Program:
    """The phase-1 product: every parsed file's module summary plus the
    import-resolved call graph the phase-2 rules traverse."""

    def __init__(self, files, root: str):
        self.root = root
        self.files = files
        self.by_rel = {f.rel: f for f in files}
        self.modules: dict[str, ModuleSummary] = {}
        self.by_module_rel: dict[str, ModuleSummary] = {}
        for sf in files:
            if sf.tree is None:
                continue
            mod = ModuleSummary(sf)
            self.modules[mod.name] = mod
            self.by_module_rel[mod.rel] = mod
        self.graph = CallGraph(self)


def build_program(files, root: str) -> Program:
    return Program(files, root)
