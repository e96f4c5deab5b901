"""Phase 1.5 — cross-process message-flow facts (docs/ANALYSIS.md).

The serve/HA/pool/distributor tiers speak a hand-rolled JSON-RPC dialect:
``{"cmd": ...}`` dicts framed by ``protocol.send_frame`` and dispatched
through ``if cmd == "..."`` chains against the closed command registries
(``SERVE_COMMANDS``, ``protocol.COMMANDS``, ``SHIP_COMMANDS``).  The name
registries are policed by R004-style rules; this module distills the
*schemas* — who sends what keys, who reads them, what comes back — so
R016 (schema drift) and R018 (chaos coverage) can check both sides.

Built lazily from the phase-1 ``summaries.Program`` (the already-parsed
trees — no new parses; the one-parse-per-file economy is pinned by
tests/test_torch_analysis_gate.py) and cached on the Program, so R016
and R018 share one build.  Facts:

  * **send sites** — dict payloads carrying a ``"cmd"`` key handed to a
    framing call.  The framing *helpers* are discovered by fixpoint from
    the ``send_frame`` seed: any function that forwards one of its own
    parameters into a known helper's payload position is itself a helper
    (``client._rpc_ok -> rpc -> _rpc_one -> send_frame``), and a helper
    whose payload is ``dict(param, cmd="x")`` ADDS that cmd
    (``pool.stage_rpc``).  Payloads resolve through dict literals,
    ``dict(base, k=v)``, same-scope ``name = {...}`` assignment plus
    ``name["k"] = v`` mutation (``If``-guarded mutations become
    *conditional* keys), and one call-graph hop into a dict-returning
    builder.  Dict keys spelled as constants (``protocol.EPOCH_KEY``)
    resolve through module-level string constants.
  * **dispatch arms** — per dispatcher (``cmd = req.get("cmd")`` + an
    ``if cmd == "..."`` / ``if cmd in REGISTRY`` chain), the keys each
    arm reads from the request: ``req["k"]`` = required, ``.get`` =
    optional, followed up to three resolvable calls deep
    (``daemon._cmd_submit -> jobs.parse_spec``).  Registered cmds with
    no explicit test claim the dispatcher's trailing body (the worker's
    ``fetch`` fall-through).  A request escaping into an unresolvable
    callee marks the arm's reads OPEN.
  * **reply shapes** — the union of dict keys an arm can return,
    following resolvable reply builders (``jobs.structured_error``);
    any unresolvable return path marks the reply OPEN.

Everything is false-negative-leaning: OPEN facts disable the checks that
would need them, they never guess.  Like the whole analyzer this imports
none of the checked code.
"""

from __future__ import annotations

import ast
import dataclasses

from locust_tpu_torch.analysis.core import call_name

# Keys owned by the wire/framing layer, never application schema: "cmd"
# itself, the replay-guard freshness stamps (protocol.send_frame adds
# them), the fencing epoch and the telemetry correlation stamp.  They are
# never "dead" at a send site and never "required" at an arm.
WIRE_META_KEYS = frozenset({"cmd", "_ts", "_nonce", "_epoch", "trace"})

# Reply keys any cmd can legitimately carry regardless of its arm: the
# transport error ladder ({"status","error"}), structured_error's
# "code", and the HA redirect/fencing decorations ("primary", "epoch").
GENERIC_REPLY_KEYS = frozenset({"status", "code", "error", "epoch", "primary"})

# Callees a request dict can be handed to without "reading" keys the
# analysis must then treat as unknown.
_BENIGN_CALLEES = frozenset({
    "dict", "len", "str", "repr", "bool", "int", "list", "tuple", "set",
    "sorted", "isinstance", "type", "id", "print", "dumps", "deepcopy",
    "copy", "format",
})

_MAX_DEPTH = 3

# Build accounting, mirroring core.parse_count(): the R016/R018 pair must
# share ONE RpcProgram per (scope, registries, seeds) — pinned in tests.
_build_count = 0


def build_count() -> int:
    return _build_count


def reset_build_count() -> None:
    global _build_count
    _build_count = 0


@dataclasses.dataclass
class Payload:
    """Resolved key set of one dict expression."""

    keys: set          # definitely present
    cond: set          # present on some paths (If-guarded subscript adds)
    open: bool = False  # unresolved parts (**kw, unknown base, var key)
    cmd: str | None = None
    from_param: str | None = None  # derives from this enclosing-fn param

    def all_keys(self) -> set:
        return self.keys | self.cond


def _merge(a: Payload, b: Payload) -> Payload:
    """Union of alternative shapes (multiple assignments / return paths)."""
    cmd = a.cmd if a.cmd == b.cmd else None
    return Payload(
        a.keys | b.keys, a.cond | b.cond,
        a.open or b.open or (a.cmd != b.cmd),
        cmd, a.from_param or b.from_param,
    )


@dataclasses.dataclass
class HelperEntry:
    """One discovered framing helper: calls to ``leaf`` carry the payload
    at positional index ``call_index`` (self excluded), and the helper
    applies ``adds_*`` to it before framing (``dict(req, cmd="...")``)."""

    leaf: str
    call_index: int
    fn: object | None        # FunctionSummary; None for the seed
    adds_cmd: str | None
    adds_keys: frozenset
    adds_cond: frozenset
    chain: tuple             # forwarding-path FunctionSummaries (R018)


@dataclasses.dataclass
class SendSite:
    rel: str
    line: int
    col: int
    fn: object               # enclosing FunctionSummary
    cmd: str
    payload: Payload
    reply_reads: set
    fns: tuple               # enclosing fn + helper chain (R018 seeds)
    synthetic: bool = False  # emitted for a cmd-adding helper whose
    #                          call sites are statically unresolvable
    #                          (first-class dispatch through an executor)


@dataclasses.dataclass
class Arm:
    cmd: str
    rel: str
    line: int
    dispatcher: object       # FunctionSummary of the dispatch function
    required: set            # req["k"] reads (no default)
    optional: set            # req.get("k") / "k" in req reads
    open_reads: bool         # req escaped into an unresolvable callee
    reply_keys: set
    open_reply: bool
    fns: tuple               # dispatcher + resolved delegates (R018)


def _param_names(node) -> list:
    a = node.args
    return [p.arg for p in a.posonlyargs + a.args]


def _own_walk(node):
    """Subtree of ``node`` (a def or a statement list) excluding nested
    function bodies — each nested def is its own FunctionSummary, so
    scanning it here would double-count its sites/reads."""
    stack = list(node) if isinstance(node, list) else [node]
    first = not isinstance(node, list)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not first:
                continue
        first = False
        yield n
        stack.extend(ast.iter_child_nodes(n))


_COND_ANCESTORS = (ast.If, ast.IfExp, ast.While, ast.For, ast.AsyncFor,
                   ast.Try, ast.ExceptHandler)


class RpcProgram:
    """The message-flow fact base R016/R018 run over."""

    def __init__(self, program, scope, registries, seeds):
        global _build_count
        _build_count += 1
        self.program = program
        self.scope = tuple(scope)
        self.mods = [
            m for m in program.modules.values()
            if m.rel.startswith(self.scope)
        ]
        # Command registries: module-level tuple-of-str constants, read
        # from the phase-1 trees (summaries.ModuleSummary.seq_consts).
        self.registry_cmds: dict[tuple, tuple] = {}
        for rel, var in registries:
            mod = program.by_module_rel.get(rel)
            cmds = mod.seq_consts.get(var) if mod is not None else None
            if cmds:
                self.registry_cmds[(rel, var)] = tuple(cmds)
        self.all_cmds = {
            c for cmds in self.registry_cmds.values() for c in cmds
        }
        self._parents: dict[int, dict] = {}
        self._returns_memo: dict[int, Payload] = {}
        self.helpers: dict[str, list[HelperEntry]] = {}
        self._helper_by_fn: dict[int, HelperEntry] = {}
        for leaf, idx in seeds:
            self.helpers.setdefault(leaf, []).append(
                HelperEntry(leaf, idx, None, None, frozenset(), frozenset(),
                            ())
            )
        self._fixpoint()
        self.sites: list[SendSite] = []
        self._collect_sites()
        self.arms: list[Arm] = []
        self._collect_arms()
        self.arm_index: dict[str, list[Arm]] = {}
        for a in self.arms:
            self.arm_index.setdefault(a.cmd, []).append(a)
        self.sites_by_cmd: dict[str, list[SendSite]] = {}
        for s in self.sites:
            self.sites_by_cmd.setdefault(s.cmd, []).append(s)

    # ------------------------------------------------------------ helpers

    def _fixpoint(self) -> None:
        for _ in range(12):
            changed = False
            for mod in self.mods:
                # module-level aliases: ``_rpc = rpc``
                for stmt in mod.sf.tree.body:
                    if (
                        isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and isinstance(stmt.value, ast.Name)
                    ):
                        dst = stmt.targets[0].id
                        for e in self.helpers.get(stmt.value.id, []):
                            if (
                                e.fn is not None
                                and e.fn.module is mod
                                and all(x is not e
                                        for x in self.helpers.get(dst, []))
                            ):
                                self.helpers.setdefault(dst, []).append(e)
                                changed = True
                for fn in mod.functions:
                    if id(fn.node) in self._helper_by_fn:
                        continue
                    ent = self._helper_candidate(fn)
                    if ent is not None:
                        self.helpers.setdefault(ent.leaf, []).append(ent)
                        self._helper_by_fn[id(fn.node)] = ent
                        changed = True
            if not changed:
                break

    def _helper_candidate(self, fn) -> HelperEntry | None:
        params = _param_names(fn.node)
        for call in self._calls_in(fn):
            entry, arg = self._match_helper_call(fn, call)
            if entry is None or arg is None:
                continue
            p = self._payload_of(arg, fn, 0)
            if p is None or p.from_param is None or p.from_param not in params:
                continue
            idx = params.index(p.from_param)
            offset = 1 if params and params[0] in ("self", "cls") else 0
            if idx - offset < 0:
                continue
            return HelperEntry(
                fn.name, idx - offset, fn,
                p.cmd or entry.adds_cmd,
                frozenset(p.keys | set(entry.adds_keys)),
                frozenset(p.cond | set(entry.adds_cond)),
                (fn,) + entry.chain,
            )
        return None

    @staticmethod
    def _calls_in(fn):
        for n in _own_walk(fn.node):
            if isinstance(n, ast.Call):
                yield n

    def _match_helper_call(self, fn, call):
        name = call_name(call)
        leaf = name.split(".")[-1]
        entries = self.helpers.get(leaf)
        if not entries:
            return None, None
        for r in self.program.graph.resolve(fn.module, name,
                                            include_nested=True):
            e = self._helper_by_fn.get(id(r.node))
            if e is not None:
                return e, _arg_at(call, e.call_index)
        tried = set()
        for e in entries:
            if e.call_index in tried:
                continue
            tried.add(e.call_index)
            arg = _arg_at(call, e.call_index)
            if arg is None:
                continue
            p = self._payload_of(arg, fn, 0)
            if p is not None and (p.from_param or p.cmd or e.adds_cmd):
                return e, arg
        return None, None

    # ----------------------------------------------------------- payloads

    def _parents_of(self, fn) -> dict:
        cached = self._parents.get(id(fn.node))
        if cached is None:
            cached = {}
            for n in ast.walk(fn.node):
                for c in ast.iter_child_nodes(n):
                    cached[id(c)] = n
            self._parents[id(fn.node)] = cached
        return cached

    def _key_const(self, k, mod) -> str | None:
        """A dict key / subscript / .get argument as a string constant,
        resolving Name/Attribute spellings (protocol.EPOCH_KEY) through
        module-level string constants."""
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            return k.value
        if isinstance(k, ast.Name):
            return mod.str_consts.get(k.id)
        if isinstance(k, ast.Attribute) and isinstance(k.value, ast.Name):
            target = mod.imports.get(k.value.id)
            m = self.program.modules.get(target) if target else None
            return m.str_consts.get(k.attr) if m is not None else None
        return None

    def _payload_of(self, expr, fn, depth, active=frozenset()):
        """Key set of a dict-shaped expression, or None when the
        expression cannot be a dict we understand at all."""
        if depth > _MAX_DEPTH:
            return Payload(set(), set(), open=True)
        if isinstance(expr, ast.Dict):
            keys, cond, open_, cmd = set(), set(), False, None
            for k, v in zip(expr.keys, expr.values):
                name = self._key_const(k, fn.module) if k is not None else None
                if name is None:
                    open_ = True  # **base or unresolvable key
                    continue
                keys.add(name)
                if name == "cmd":
                    if isinstance(v, ast.Constant) and isinstance(v.value,
                                                                  str):
                        cmd = v.value
                    else:
                        open_ = True
            return Payload(keys, cond, open_, cmd)
        if isinstance(expr, ast.Call):
            name = call_name(expr)
            if name.split(".")[-1] == "dict":
                base = Payload(set(), set())
                if expr.args:
                    b = self._payload_of(expr.args[0], fn, depth, active)
                    base = b if b is not None else Payload(set(), set(),
                                                           open=True)
                keys, open_, cmd = set(), base.open, base.cmd
                for kw in expr.keywords:
                    if kw.arg is None:
                        open_ = True
                        continue
                    keys.add(kw.arg)
                    if kw.arg == "cmd":
                        if isinstance(kw.value, ast.Constant) and isinstance(
                            kw.value.value, str
                        ):
                            cmd = kw.value.value
                        else:
                            open_ = True
                            cmd = None
                return Payload(base.keys | keys, set(base.cond), open_, cmd,
                               base.from_param)
            targets = self.program.graph.resolve(fn.module, name,
                                                 include_nested=True)
            if targets:
                merged = None
                for t in targets:
                    p = self._returns_payload(t, depth + 1)
                    merged = p if merged is None else _merge(merged, p)
                return merged
            return Payload(set(), set(), open=True)
        if isinstance(expr, ast.Name):
            return self._name_payload(expr.id, fn, depth, active)
        return Payload(set(), set(), open=True)

    def _name_payload(self, name, fn, depth, active):
        params = _param_names(fn.node)
        if name in active:
            # re-reference while resolving the same name: the value
            # before reassignment (``req = dict(req, cmd=...)``).
            if name in params:
                return Payload(set(), set(), from_param=name)
            return Payload(set(), set(), open=True)
        assigns = [
            n for n in _own_walk(fn.node)
            if (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == name
            )
            or (
                # ``req: dict = {...}`` — client.submit/invalidate
                isinstance(n, ast.AnnAssign)
                and isinstance(n.target, ast.Name)
                and n.target.id == name
                and n.value is not None
            )
        ]
        merged = None
        for a in assigns:
            p = self._payload_of(a.value, fn, depth + 1, active | {name})
            if p is not None:
                merged = p if merged is None else _merge(merged, p)
        if merged is None:
            if name in params:
                return Payload(set(), set(), from_param=name)
            return Payload(set(), set(), open=True)
        parents = self._parents_of(fn)
        for n in _own_walk(fn.node):
            if (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Subscript)
                and isinstance(n.targets[0].value, ast.Name)
                and n.targets[0].value.id == name
            ):
                k = self._key_const(n.targets[0].slice, fn.module)
                if k is None:
                    merged.open = True
                    continue
                if self._conditional(n, fn, parents):
                    merged.cond.add(k)
                else:
                    merged.keys.add(k)
                if k == "cmd" and isinstance(n.value, ast.Constant) and \
                        isinstance(n.value.value, str):
                    merged.cmd = n.value.value
        return merged

    def _conditional(self, node, fn, parents) -> bool:
        n = parents.get(id(node))
        while n is not None and n is not fn.node:
            if isinstance(n, _COND_ANCESTORS):
                return True
            n = parents.get(id(n))
        return False

    def _returns_payload(self, t_fn, depth) -> Payload:
        key = id(t_fn.node)
        memo = self._returns_memo.get(key)
        if memo is not None:
            return memo
        self._returns_memo[key] = Payload(set(), set(), open=True)  # cycle
        merged = None
        for n in _own_walk(t_fn.node):
            if isinstance(n, ast.Return):
                if n.value is None:
                    p = Payload(set(), set(), open=True)
                else:
                    p = self._payload_of(n.value, t_fn, depth)
                    if p is None:
                        p = Payload(set(), set(), open=True)
                merged = p if merged is None else _merge(merged, p)
        if merged is None:
            merged = Payload(set(), set(), open=True)
        self._returns_memo[key] = merged
        return merged

    # -------------------------------------------------------- send sites

    def _collect_sites(self) -> None:
        seen = set()
        for mod in self.mods:
            for fn in mod.functions:
                for call in self._calls_in(fn):
                    entry, arg = self._match_helper_call(fn, call)
                    if entry is None:
                        continue
                    key = (mod.rel, call.lineno, call.col_offset)
                    if key in seen:
                        continue
                    seen.add(key)
                    p = (self._payload_of(arg, fn, 0)
                         if arg is not None else None)
                    if p is None:
                        p = Payload(set(), set(), open=True)
                    if p.from_param is not None:
                        continue  # helper-internal forwarding
                    cmd = p.cmd or entry.adds_cmd
                    if cmd is None:
                        continue  # replies / frames without a cmd
                    payload = Payload(
                        p.keys | set(entry.adds_keys),
                        p.cond | set(entry.adds_cond), p.open, cmd,
                    )
                    self.sites.append(SendSite(
                        mod.rel, call.lineno, call.col_offset, fn, cmd,
                        payload, self._reply_reads(call, fn),
                        (fn,) + entry.chain,
                    ))
        # A helper that ADDS a const cmd is itself the send surface for
        # that cmd when its callers are statically unresolvable (the
        # daemon hands ``_run_plan_stage_rpc`` to an executor as a
        # value).  Emit one OPEN site at the helper def: the fencing
        # check still sees its adds, and the required-read check knows
        # this cmd has senders it cannot enumerate.
        for entries in self.helpers.values():
            for e in entries:
                if e.fn is None or e.adds_cmd is None:
                    continue
                key = ("helper", id(e.fn.node))
                if key in seen:
                    continue
                seen.add(key)
                self.sites.append(SendSite(
                    e.fn.rel, e.fn.lineno, 0, e.fn, e.adds_cmd,
                    Payload(set(e.adds_keys), set(e.adds_cond), True,
                            e.adds_cmd),
                    set(), (e.fn,) + e.chain, synthetic=True,
                ))

    def _reply_reads(self, call, fn) -> set:
        parents = self._parents_of(fn)
        par = parents.get(id(call))
        reads: set = set()
        if (
            isinstance(par, ast.Assign)
            and len(par.targets) == 1
            and isinstance(par.targets[0], ast.Name)
        ):
            rname = par.targets[0].id
            for n in _own_walk(fn.node):
                if (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "get"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == rname
                    and n.args
                ):
                    k = self._key_const(n.args[0], fn.module)
                    if k:
                        reads.add(k)
                elif (
                    isinstance(n, ast.Subscript)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == rname
                    and isinstance(n.ctx, ast.Load)
                ):
                    k = self._key_const(n.slice, fn.module)
                    if k:
                        reads.add(k)
        elif isinstance(par, ast.Attribute) and par.attr == "get":
            gp = parents.get(id(par))
            if isinstance(gp, ast.Call) and gp.func is par and gp.args:
                k = self._key_const(gp.args[0], fn.module)
                if k:
                    reads.add(k)
        return reads

    # --------------------------------------------------- dispatcher arms

    def _collect_arms(self) -> None:
        for mod in self.mods:
            for fn in mod.functions:
                disp = self._dispatcher_of(fn)
                if disp is not None:
                    self._arms_of(fn, *disp)

    def _dispatcher_of(self, fn):
        params = set(_param_names(fn.node))
        for n in _own_walk(fn.node):
            if (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Call)
                and isinstance(n.value.func, ast.Attribute)
                and n.value.func.attr == "get"
                and isinstance(n.value.func.value, ast.Name)
                and n.value.func.value.id in params
                and n.value.args
                and isinstance(n.value.args[0], ast.Constant)
                and n.value.args[0].value == "cmd"
            ):
                return n.targets[0].id, n.value.func.value.id
        return None

    def _registry_expr(self, expr, mod):
        if isinstance(expr, ast.Name):
            return mod.seq_consts.get(expr.id)
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name):
            target = mod.imports.get(expr.value.id)
            m = self.program.modules.get(target) if target else None
            return m.seq_consts.get(expr.attr) if m is not None else None
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            out = []
            for e in expr.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    out.append(e.value)
                else:
                    return None
            return tuple(out)
        return None

    def _cmds_of_test(self, test, cmd_var, mod):
        """(explicit arm cmds, not-in gate registry or None)."""
        if isinstance(test, ast.BoolOp):
            cmds: set = set()
            gate = None
            for v in test.values:
                c, g = self._cmds_of_test(v, cmd_var, mod)
                cmds |= c
                gate = gate or g
            return cmds, gate
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return set(), None  # a negated cmd test is a gate, not an arm
        if (
            isinstance(test, ast.Compare)
            and isinstance(test.left, ast.Name)
            and test.left.id == cmd_var
            and len(test.ops) == 1
        ):
            op, comp = test.ops[0], test.comparators[0]
            if isinstance(op, ast.Eq):
                if isinstance(comp, ast.Constant) and isinstance(comp.value,
                                                                 str):
                    return {comp.value}, None
            elif isinstance(op, ast.In):
                reg = self._registry_expr(comp, mod)
                if reg:
                    return set(reg), None
            elif isinstance(op, ast.NotIn):
                reg = self._registry_expr(comp, mod)
                if reg:
                    return set(), tuple(reg)
        return set(), None

    def _arms_of(self, fn, cmd_var, req_param) -> None:
        mod = fn.module
        arm_specs = []
        gate_registry = None
        for n in _own_walk(fn.node):
            if not isinstance(n, ast.If):
                continue
            cmds, gate = self._cmds_of_test(n.test, cmd_var, mod)
            if gate is not None and gate_registry is None:
                gate_registry = gate
            if cmds:
                arm_specs.append((cmds, n))
        explicit: set = set()
        for cmds, _ in arm_specs:
            explicit |= cmds
        body = list(fn.node.body)
        arm_if_ids = {id(n) for _, n in arm_specs}
        last = -1
        for i, stmt in enumerate(body):
            if id(stmt) in arm_if_ids:
                last = i
        trailing_body = body[last + 1:] if last >= 0 else []
        trailing_cmds = set(gate_registry or ()) - explicit

        banned: set = set()
        for _, n in arm_specs:
            for b in n.body:
                banned.update(id(x) for x in ast.walk(b))
        for stmt in trailing_body:
            banned.update(id(x) for x in ast.walk(stmt))
        common = self._reads_of_body(body, fn, req_param, banned=banned)

        for cmds, n in arm_specs:
            r = self._reads_of_body(n.body, fn, req_param)
            reply_keys, open_reply = self._reply_of_body(n.body, fn)
            for c in sorted(cmds):
                self.arms.append(Arm(
                    c, mod.rel, n.lineno, fn,
                    set(r.required),
                    set(r.optional) | set(common.required)
                    | set(common.optional),
                    r.open or common.open, reply_keys, open_reply,
                    (fn,) + tuple(r.fns),
                ))
        if trailing_cmds:
            if trailing_body:
                r = self._reads_of_body(trailing_body, fn, req_param)
                reply_keys, open_reply = self._reply_of_body(trailing_body,
                                                             fn)
            else:
                r = _Reads()
                r.open = True
                reply_keys, open_reply = set(), True
            line = trailing_body[0].lineno if trailing_body else fn.lineno
            for c in sorted(trailing_cmds):
                self.arms.append(Arm(
                    c, mod.rel, line, fn,
                    set(r.required),
                    set(r.optional) | set(common.required)
                    | set(common.optional),
                    r.open or common.open, reply_keys, open_reply,
                    (fn,) + tuple(r.fns),
                ))

    def _reads_of_body(self, stmts, fn, param, depth=0, visited=None,
                       banned=None):
        r = _Reads()
        if visited is None:
            visited = set()
        vkey = (id(fn.node), param)
        if vkey in visited or depth > _MAX_DEPTH:
            r.open = depth > _MAX_DEPTH
            return r
        visited.add(vkey)
        for n in _own_walk(stmts):
            if banned is not None and id(n) in banned:
                continue
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == param
            ):
                if n.func.attr == "get" and n.args:
                    k = self._key_const(n.args[0], fn.module)
                    if k is None:
                        r.open = True
                    else:
                        r.optional.add(k)
                elif n.func.attr in ("items", "keys", "values"):
                    r.open = True  # iterates every key
                continue
            if (
                isinstance(n, ast.Subscript)
                and isinstance(n.value, ast.Name)
                and n.value.id == param
                and isinstance(n.ctx, ast.Load)
            ):
                k = self._key_const(n.slice, fn.module)
                if k is None:
                    r.open = True
                else:
                    r.required.add(k)
                continue
            if (
                isinstance(n, ast.Compare)
                and len(n.ops) == 1
                and isinstance(n.ops[0], (ast.In, ast.NotIn))
                and isinstance(n.comparators[0], ast.Name)
                and n.comparators[0].id == param
            ):
                k = self._key_const(n.left, fn.module)
                if k is not None:
                    r.optional.add(k)
                continue
            if isinstance(n, ast.Call):
                self._follow_req(n, fn, param, r, depth, visited)
        return r

    def _follow_req(self, call, fn, param, r, depth, visited) -> None:
        """A call receiving the request dict: recurse into resolvable
        callees' reads; anything else opens the arm."""
        passed_at = [
            i for i, a in enumerate(call.args)
            if isinstance(a, ast.Name) and a.id == param
        ]
        passed_kw = any(
            isinstance(kw.value, ast.Name) and kw.value.id == param
            for kw in call.keywords
        )
        if not passed_at and not passed_kw:
            return
        name = call_name(call)
        if name.split(".")[-1] in _BENIGN_CALLEES:
            return
        if passed_kw:
            r.open = True
            return
        targets = self.program.graph.resolve(fn.module, name,
                                             include_nested=True)
        if not targets:
            r.open = True
            return
        for t in targets:
            tparams = _param_names(t.node)
            offset = (
                1 if tparams and tparams[0] in ("self", "cls")
                and isinstance(call.func, ast.Attribute) else 0
            )
            for i in passed_at:
                if i + offset >= len(tparams):
                    r.open = True
                    continue
                sub = self._reads_of_body(
                    list(t.node.body), t, tparams[i + offset],
                    depth + 1, visited,
                )
                r.required |= sub.required
                r.optional |= sub.optional
                r.open = r.open or sub.open
                r.fns.append(t)
                r.fns.extend(sub.fns)

    def _reply_of_body(self, stmts, fn):
        merged = None
        for n in _own_walk(stmts):
            if isinstance(n, ast.Return):
                if n.value is None:
                    p = Payload(set(), set(), open=True)
                else:
                    p = self._payload_of(n.value, fn, 1)
                    if p is None:
                        p = Payload(set(), set(), open=True)
                merged = p if merged is None else _merge(merged, p)
        if merged is None:
            return set(), True
        return merged.all_keys(), merged.open or merged.from_param is not None


class _Reads:
    def __init__(self):
        self.required: set = set()
        self.optional: set = set()
        self.open = False
        self.fns: list = []


def _arg_at(call, idx):
    if idx < len(call.args):
        a = call.args[idx]
        if isinstance(a, ast.Starred):
            return None
        return a
    return None


def get(program, scope, registries, seeds) -> RpcProgram:
    """The cached RpcProgram for this (scope, registries, seeds) — R016
    and R018 share one build per analysis run (pinned alongside the
    parse-once economy in tests/test_torch_analysis_gate.py)."""
    cache = program.__dict__.setdefault("_rpcflow_cache", {})
    key = (tuple(scope), tuple(registries), tuple(seeds))
    if key not in cache:
        cache[key] = RpcProgram(program, scope, registries, seeds)
    return cache[key]
