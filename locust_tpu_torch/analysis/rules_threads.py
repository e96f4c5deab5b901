"""R001/R012 — thread-shared state and thread/executor lifecycle.

R001 (interprocedural lockset): a function that RUNS ON A THREAD
(``threading.Thread(target=...)``, ``executor.submit(fn)``,
``executor.map(fn)``) must not write ``self.*`` attributes, ``global``
names, or own-``nonlocal`` closure slots outside a ``with <lock>:``
block.  Since the two-phase engine, the Eraser-style (Savage et al.,
1997) lockset follows CALLS from the entry point across modules through
the summaries call graph, with the lock context propagated along the
chain: ``Thread(target=self._loop)`` where ``_loop`` calls ``_once``
which writes ``self._mark`` unlocked is a finding in ``_once`` — the
exact shape the JAX serve dispatcher once shipped with.

Heuristics (documented in docs/ANALYSIS.md):

  * entry points resolve by name (nested defs included); calls resolve
    through the attribution-only call graph (callgraph.py) and only
    into top-level functions/methods — a callee nested in the caller is
    already covered by the caller's whole-subtree summary;
  * "a lock" is any ``with`` whose context expression mentions
    lock/mutex/semaphore/cond; a call made INSIDE such a ``with`` marks
    its whole callee chain as lock-covered ("caller holds the lock"
    conventions like daemon._corpus_put stay silent);
  * locals and attribute writes on non-``self`` receivers are not
    flagged (thread-private by construction in this codebase).

R012 (thread/executor lifecycle): every ``threading.Thread`` in the
package must be daemonized or joined somewhere in its module;
every bound executor must be ``with``-managed or ``.shutdown(...)``.  A
non-daemon thread nobody joins outlives crashes and wedges interpreter
exit — the dispatcher-join and warm-writer-close review incidents
(serve/daemon.py close(), io/snapshot.py close()) as a machine check.
"""

from __future__ import annotations

import ast

from locust_tpu_torch.analysis.core import Finding, Rule, unparse


class ThreadSharedStateRule(Rule):
    rule_id = "R001"
    title = "thread-shared state written without a lock"

    _MAX_DEPTH = 8

    def check_program(self, program):
        emitted: set[tuple] = set()
        for mod in program.modules.values():
            for ref, how in mod.thread_entries:
                for fn in self._resolve_entry(program, mod, ref):
                    yield from self._visit(
                        program, fn, how, entry=fn.name, chain=(fn.name,),
                        locked=False, depth=0, visited={}, emitted=emitted,
                    )

    def _resolve_entry(self, program, mod, ref):
        if isinstance(ref, ast.Lambda):
            return [mod.lambda_summary(ref)]
        if isinstance(ref, ast.Name):
            return program.graph.resolve(mod, ref.id, include_nested=True)
        if isinstance(ref, ast.Attribute):
            return program.graph.resolve(
                mod, unparse(ref), include_nested=True
            )
        return []

    def _visit(self, program, fn, how, entry, chain, locked, depth,
               visited, emitted):
        # Revisit only when arriving with a WEAKER lock context than any
        # prior visit (unlocked findings dominate).  A depth-truncated
        # visit is NOT recorded: it never explored its callees, and
        # marking it would blind a later shallower path (the emitted-set
        # dedups any re-reported writes; depth still bounds recursion).
        prev = visited.get(id(fn.node))
        if prev is not None and (prev is False or locked):
            return
        if depth < self._MAX_DEPTH:
            visited[id(fn.node)] = locked
        for w in fn.writes:
            if locked or w.locked:
                continue
            key = (fn.rel, w.line, w.desc)
            if key in emitted:
                continue
            emitted.add(key)
            if len(chain) == 1:
                detail = f"'{fn.name}' runs on a thread ({how})"
            else:
                detail = (
                    f"'{fn.name}' is reached from thread entry "
                    f"'{entry}' ({how}) via {' -> '.join(chain)}"
                )
            yield Finding(
                self.rule_id, fn.rel, w.line, w.col,
                f"{detail} and writes shared state {w.desc} with no "
                "enclosing 'with <lock>:' on the call path — a data race "
                "heuristic; guard it or noqa with the synchronization "
                "argument",
            )
        if depth >= self._MAX_DEPTH:
            return
        for c in fn.calls:
            targets = program.graph.resolve(fn.module, c.callee)
            for callee in targets:
                if callee.node is fn.node:
                    continue
                yield from self._visit(
                    program, callee, how, entry,
                    chain + (callee.name,), locked or c.locked,
                    depth + 1, visited, emitted,
                )


class ThreadLifecycleRule(Rule):
    rule_id = "R012"
    title = "thread/executor without a daemon flag, join, or shutdown"

    def check_program(self, program):
        for mod in program.modules.values():
            if not mod.rel.startswith(self.layout.prefix):
                continue  # tests/scripts own their process lifetime
            for s in mod.spawns:
                if s.kind == "thread":
                    if s.daemon:
                        continue
                    if s.bound is not None and s.bound in mod.joined:
                        continue
                    if s.bound is None and not s.chained_start:
                        continue  # passed/returned: can't attribute
                    where = (
                        f"bound to {s.bound!r}" if s.bound
                        else "started inline"
                    )
                    yield Finding(
                        self.rule_id, mod.rel, s.line, s.col,
                        f"non-daemon Thread {where} is never joined in "
                        "this module — it outlives crashes and wedges "
                        "interpreter exit; pass daemon=True or join it on "
                        "a reachable close path (the serve dispatcher-join "
                        "/ warm-writer-close incidents)",
                    )
                else:  # executor
                    if s.in_with:
                        continue
                    if s.bound is not None and s.bound in mod.shutdown:
                        continue
                    if s.bound is None:
                        continue  # unattributable construction
                    yield Finding(
                        self.rule_id, mod.rel, s.line, s.col,
                        f"executor bound to {s.bound!r} has no "
                        "``with``-scope and no .shutdown(...) call in "
                        "this module — worker threads leak past the work "
                        "they were built for; scope it or shut it down on "
                        "a reachable close path",
                    )


# ------------------------------------------------------------------ R013

# Blocking primitives whose no-timeout form can park a thread forever.
# join()/wait()/result() are bounded by a timeout ARGUMENT; accept()/
# recv*() are bounded by the socket's settimeout() deadline instead.
_ARG_BOUNDED = {"join", "wait", "result"}
_SOCKET_BOUNDED = {"accept", "recv", "recv_into", "recvfrom"}


class UnboundedBlockingRule(Rule):
    """R013 — unbounded-blocking hygiene in the daemon tiers.

    The serve and distributor tiers promise "never a hang": every wait a
    wedged peer, a dead dispatcher, or a saturated pool can extend must
    carry a deadline (the ServeClient.wait / dispatcher-join /
    fetch-pool incidents as a machine check).  Heuristics:

      * ``x.join()`` / ``x.wait()`` / ``x.result()`` with NO positional
        argument and no ``timeout=`` keyword fire (``",".join(parts)``
        and ``os.path.join(a, b)`` always pass arguments, so the
        no-argument form is the thread/future one);
      * ``x.accept()`` / ``x.recv*(...)`` fire unless the receiver is a
        function PARAMETER (the caller owns the socket's deadline — the
        protocol-layer convention) or the enclosing scope visibly calls
        ``settimeout``;
      * deliberate unbounded waits take a reason-noqa, like every rule.
    """

    rule_id = "R013"
    title = "unbounded blocking call in a daemon tier"

    def __init__(self, layout=None):
        super().__init__(layout)
        self.scopes = (self.layout.rel("serve/"),
                       self.layout.rel("distributor/"))

    def check_file(self, f, root):
        if not any(f.rel.startswith(p) for p in self.scopes):
            return
        for scope in self._scopes_of(f.tree):
            params = self._params(scope)
            has_settimeout = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "settimeout"
                for n in ast.walk(scope)
            )
            for node in self._own_calls(scope):
                if not isinstance(node.func, ast.Attribute):
                    continue
                leaf = node.func.attr
                if leaf in _ARG_BOUNDED:
                    if node.args or any(
                        kw.arg == "timeout" for kw in node.keywords
                    ):
                        continue
                    yield Finding(
                        self.rule_id, f.rel, node.lineno, node.col_offset,
                        f".{leaf}() without a timeout can park this "
                        "thread forever on a wedged peer/thread — pass "
                        "a timeout (or reason-noqa a deliberate forever-"
                        "wait)",
                    )
                elif leaf in _SOCKET_BOUNDED:
                    recv = node.func.value
                    if isinstance(recv, ast.Name) and recv.id in params:
                        continue  # caller owns the socket deadline
                    if has_settimeout:
                        continue
                    yield Finding(
                        self.rule_id, f.rel, node.lineno, node.col_offset,
                        f".{leaf}() on a socket with no settimeout() in "
                        "this scope blocks forever on a silent peer — "
                        "set a deadline before blocking on the wire",
                    )

    @staticmethod
    def _scopes_of(tree):
        """Module + each function body (innermost wins for ownership)."""
        scopes = [tree]
        scopes.extend(
            n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        )
        return scopes

    @staticmethod
    def _params(scope):
        if not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return set()
        a = scope.args
        return {
            p.arg
            for p in a.args + a.kwonlyargs + a.posonlyargs
        }

    @staticmethod
    def _own_calls(scope):
        """Calls belonging to ``scope`` and not to a nested def (each
        nested def is its own scope in _scopes_of — reporting a call
        from both would duplicate findings)."""
        nested = [
            n for n in ast.walk(scope)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not scope
        ]
        banned = {id(n) for nd in nested for n in ast.walk(nd)}
        for n in ast.walk(scope):
            if isinstance(n, ast.Call) and id(n) not in banned:
                yield n
