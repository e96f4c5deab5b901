"""R016/R017/R018 — RPC schema conformance, silent thread death, chaos
coverage (the cross-process message-flow rules; facts from rpcflow.py).

R016 (rpc schema drift, two-sided): the registries police cmd NAMES;
this rule polices the key schemas on both sides of every cmd.  A send
site whose cmd is unregistered or has no resolvable dispatcher arm is a
*phantom cmd* — never baselineable debt (``Finding.baselineable`` is
False; ``--write-baseline`` refuses it).  A handler read with no default
(``req["k"]``) must be supplied by a send site; a key a closed send site
carries that no arm ever reads is dead weight on the wire; a reply key a
client reads that no arm produces is the stale-epoch-reply-shape
incident as a machine check.  Epoch-fenced cmds (the ship
plane + the fenced pool RPCs) must carry ``protocol.EPOCH_KEY`` at every
send site.  All checks gate on CLOSED facts only — an OPEN payload, arm
or reply disables exactly the checks that would need it.

R017 (silent thread death): the shipper, dispatcher and heartbeat loops
are "never a hang" tiers where a silently dead thread IS the hang.  Two
shapes: a ``threading.Thread`` target whose body can exit via an
uncaught exception (no broad except in it or one resolvable call away;
executor callables are covered when the spawning module reads futures —
``.result()`` re-raises there), and an ``except Exception: pass``-shaped
swallow anywhere in the package (a broad handler whose body neither
calls anything — no logging, no recording — nor re-raises nor uses the
bound exception).

R018 (chaos-coverage drift): every discovered cmd needs a plane
(job/data/control); every job- or data-plane cmd must reach a
``faultplan`` hook (fire/mangle/delay/damage_file) within two call hops
of its handler arm, dispatcher, or send path — excluding the generic
frame-layer hooks (rpc.connect / rpc.frame in distributor/protocol.py),
which fire for every frame and therefore distinguish nothing.  New RPCs
cannot ship chaos-blind (docs/FAULTS.md).
"""

from __future__ import annotations

import ast

from locust_tpu_torch.analysis import rpcflow
from locust_tpu_torch.analysis.core import Finding, Rule, call_name, unparse

# The wire tiers (package-relative): every send_frame/recv_frame caller
# lives here.  The analysis package itself is deliberately OUT of scope —
# rpcflow analyzing its own helper-matching code manufactures phantom
# helpers.
DEFAULT_SCOPE = ("serve/", "distributor/")
DEFAULT_REGISTRIES = (
    ("serve/daemon.py", "SERVE_COMMANDS"),
    ("distributor/protocol.py", "COMMANDS"),
    ("distributor/protocol.py", "SHIP_COMMANDS"),
)
DEFAULT_SEEDS = (("send_frame", 1),)


class _RpcRuleBase(Rule):
    """Shared rpcflow access: R016 and R018 with identical (scope,
    registries, seeds) share ONE RpcProgram build per run (cached on the
    Program; pinned by tests)."""

    seeds = DEFAULT_SEEDS

    def __init__(self, layout=None):
        super().__init__(layout)
        self.scope = tuple(self.layout.rel(s) for s in DEFAULT_SCOPE)
        self.registries = tuple(
            (self.layout.rel(rel), var) for rel, var in DEFAULT_REGISTRIES
        )

    def _rpc(self, program) -> rpcflow.RpcProgram:
        return rpcflow.get(program, self.scope, self.registries, self.seeds)


class RpcSchemaRule(_RpcRuleBase):
    rule_id = "R016"
    title = "rpc schema drift between send sites and handler arms"

    # Epoch fencing: every cmd in these registries plus these named cmds
    # must carry protocol.EPOCH_KEY at every closed send site.
    fenced_registry_vars = ("SHIP_COMMANDS",)
    fenced_cmds = ("serve_batch", "plan_stage")
    epoch_key = "_epoch"

    def check_program(self, program):
        rp = self._rpc(program)
        if not rp.registry_cmds:
            return  # no registries in this tree (fixture subset)
        fenced = set(self.fenced_cmds)
        for (_, var), cmds in rp.registry_cmds.items():
            if var in self.fenced_registry_vars:
                fenced.update(cmds)
        registry_names = ", ".join(
            sorted({var for _, var in rp.registry_cmds})
        )
        phantom_seen: set = set()
        for s in rp.sites:
            if s.cmd not in rp.all_cmds:
                f = Finding(
                    self.rule_id, s.rel, s.line, s.col,
                    f"send site for cmd {s.cmd!r} — not in any command "
                    f"registry ({registry_names}); register it or fix the "
                    "typo (a phantom cmd has no handler and is never "
                    "baselineable debt)",
                )
                f.baselineable = False
                yield f
                continue
            if not rp.arm_index.get(s.cmd) and s.cmd not in phantom_seen:
                phantom_seen.add(s.cmd)
                f = Finding(
                    self.rule_id, s.rel, s.line, s.col,
                    f"cmd {s.cmd!r} is sent and registered but no "
                    "dispatcher arm handles it (phantom cmd — never "
                    "baselineable debt); add the arm or retire the sender",
                )
                f.baselineable = False
                yield f
            if (
                s.cmd in fenced
                and self.epoch_key not in s.payload.all_keys()
                and not s.payload.open
            ):
                yield Finding(
                    self.rule_id, s.rel, s.line, s.col,
                    f"epoch-fenced cmd {s.cmd!r} sent without "
                    f"protocol.EPOCH_KEY ({self.epoch_key!r}) — an "
                    "unfenced ship/stage RPC lets a partitioned old "
                    "primary be honored after promotion (docs/SERVING.md "
                    "fencing)",
                )
            arms = rp.arm_index.get(s.cmd, [])
            if s.reply_reads and arms and all(
                not a.open_reply for a in arms
            ):
                allowed = rpcflow.GENERIC_REPLY_KEYS.union(
                    *[a.reply_keys for a in arms]
                )
                for k in sorted(s.reply_reads - allowed):
                    yield Finding(
                        self.rule_id, s.rel, s.line, s.col,
                        f"client reads reply key {k!r} for cmd {s.cmd!r} "
                        "but no handler arm produces it (the stale-epoch-"
                        "reply-shape incident class)",
                    )
        for cmd in sorted(rp.sites_by_cmd):
            sites = rp.sites_by_cmd[cmd]
            arms = rp.arm_index.get(cmd, [])
            closed = [
                s for s in sites if not s.payload.open and not s.synthetic
            ]
            any_open = any(s.payload.open or s.synthetic for s in sites)
            if closed and not any_open:
                supplied: set = set()
                for s in closed:
                    supplied |= s.payload.all_keys()
                for a in arms:
                    missing = a.required - rpcflow.WIRE_META_KEYS - supplied
                    for k in sorted(missing):
                        yield Finding(
                            self.rule_id, a.rel, a.line, 0,
                            f"handler arm for cmd {cmd!r} requires key "
                            f"{k!r} (req[...] with no default) but no send "
                            "site supplies it — every request for this cmd "
                            "raises KeyError in the handler",
                        )
            if arms and all(not a.open_reads for a in arms):
                consumed = set(rpcflow.WIRE_META_KEYS)
                for a in arms:
                    consumed |= a.required | a.optional
                for s in closed:
                    for k in sorted(s.payload.all_keys() - consumed):
                        yield Finding(
                            self.rule_id, s.rel, s.line, s.col,
                            f"dead payload key {k!r} sent with cmd {cmd!r} "
                            "— no handler arm reads it; drop it or wire up "
                            "the read (schema drift, the "
                            "unknown_job class)",
                        )


def _broad_handler(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return any(n in ("Exception", "BaseException") for n in names)


def _has_broad_try(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Try) and any(
            _broad_handler(h) for h in n.handlers
        ):
            return True
    return False


class SilentThreadDeathRule(Rule):
    rule_id = "R017"
    title = "silent thread death / silent broad-except swallow"

    def __init__(self, layout=None):
        super().__init__(layout)
        self.scope = (self.layout.prefix,)

    # --------------------------------------------------- swallow shapes

    def check_file(self, f, root):
        if not f.rel.startswith(tuple(self.scope)) or f.tree is None:
            return
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _broad_handler(node):
                continue
            has_call = has_raise = uses_exc = False
            for stmt in node.body:
                for x in ast.walk(stmt):
                    if isinstance(x, ast.Call):
                        has_call = True
                    elif isinstance(x, ast.Raise):
                        has_raise = True
                    elif (
                        isinstance(x, ast.Name)
                        and node.name is not None
                        and x.id == node.name
                    ):
                        uses_exc = True
            if has_call or has_raise or uses_exc:
                continue
            yield Finding(
                self.rule_id, f.rel, node.lineno, node.col_offset,
                "broad except swallows the exception without logging, "
                "recording, or re-raising — in the never-a-hang tiers a "
                "silently eaten error is invisible until it IS the hang; "
                "log it (logger.warning/debug) or noqa with the reason "
                "the silence is safe",
            )

    # ------------------------------------------------- thread-death arm

    def check_program(self, program):
        seen: set = set()
        for mod in program.modules.values():
            if not mod.rel.startswith(tuple(self.scope)):
                continue
            module_reads_futures = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "result"
                for n in ast.walk(mod.sf.tree)
            )
            for ref, how in mod.thread_entries:
                if (
                    how.startswith("executor")
                    and module_reads_futures
                ):
                    continue  # futures re-raise at .result()
                for fn in self._resolve_entry(program, mod, ref):
                    key = (fn.rel, fn.lineno)
                    if key in seen:
                        continue
                    seen.add(key)
                    if not fn.calls:
                        continue  # nothing in the body can raise much
                    if self._protected(program, fn):
                        continue
                    yield Finding(
                        self.rule_id, fn.rel, fn.lineno,
                        fn.node.col_offset,
                        f"thread entry '{fn.name}' ({how}) can exit via "
                        "an uncaught exception — the thread dies silently "
                        "and in the never-a-hang tiers a dead "
                        "shipper/dispatcher/heartbeat loop IS the hang; "
                        "wrap the body in a broad except that logs (and "
                        "keeps the loop alive or marks the owner dead)",
                    )

    @staticmethod
    def _resolve_entry(program, mod, ref):
        if isinstance(ref, ast.Lambda):
            return [mod.lambda_summary(ref)]
        if isinstance(ref, ast.Name):
            return program.graph.resolve(mod, ref.id, include_nested=True)
        if isinstance(ref, ast.Attribute):
            return program.graph.resolve(
                mod, unparse(ref), include_nested=True
            )
        return []

    @staticmethod
    def _protected(program, fn) -> bool:
        if _has_broad_try(fn.node):
            return True
        for c in fn.calls:
            for t in program.graph.resolve(fn.module, c.callee,
                                           include_nested=True):
                if t.node is fn.node:
                    continue
                if _has_broad_try(t.node):
                    return True
        return False


class ChaosCoverageRule(_RpcRuleBase):
    rule_id = "R018"
    title = "rpc cmd without reachable faultplan chaos coverage"

    # Every discovered cmd must be classified; job/data-plane cmds must
    # reach a faultplan hook.  A NEW cmd therefore fails loudly here
    # until it is classified AND chaos-covered (or exempted with a
    # documented reason in ``exempt``).
    planes = {
        "submit": "job", "map": "job", "serve_batch": "job",
        "plan_stage": "job",
        "fetch": "data", "ship": "data", "ship_catchup": "data",
        "ship_spill": "data",
        "ping": "control", "status": "control", "result": "control",
        "cancel": "control", "invalidate": "control", "stats": "control",
        "serve_stats": "control", "shutdown": "control",
        "promote": "control",
    }
    exempt: dict = {}  # cmd -> documented reason
    generic_sites = ("rpc.connect", "rpc.frame")
    hook_names = ("fire", "mangle", "delay", "damage_file")
    hops = 2

    def __init__(self, layout=None):
        super().__init__(layout)
        # Hooks in the frame layer fire for EVERY frame — they
        # distinguish nothing per-cmd and do not count as coverage.
        self.exclude_hook_rels = (
            self.layout.rel("distributor/protocol.py"),
        )

    def check_program(self, program):
        rp = self._rpc(program)
        if not rp.registry_cmds:
            return
        discovered = set(rp.all_cmds) | set(rp.sites_by_cmd)
        for cmd in sorted(discovered):
            if cmd in self.exempt:
                continue
            rel, line = self._loc(rp, cmd)
            plane = self.planes.get(cmd)
            if plane is None:
                yield Finding(
                    self.rule_id, rel, line, 0,
                    f"cmd {cmd!r} has no plane classification — add it to "
                    "R018.planes as job/data/control (job and data cmds "
                    "then need a reachable faultplan site) or exempt it "
                    "with a documented reason",
                )
                continue
            if plane == "control":
                continue
            if not self._covered(
                program, self._seeds(rp, cmd)
            ) and not self._dispatcher_hook(rp, cmd):
                yield Finding(
                    self.rule_id, rel, line, 0,
                    f"{plane}-plane cmd {cmd!r} is not reachable from any "
                    "faultplan chaos site (fire/mangle/delay/damage_file "
                    "outside the generic frame layer) — new RPCs must not "
                    "ship chaos-blind; add a site (docs/FAULTS.md) or "
                    "exempt it with a documented reason",
                )

    @staticmethod
    def _loc(rp, cmd):
        for a in rp.arm_index.get(cmd, []):
            return a.rel, a.line
        for s in rp.sites_by_cmd.get(cmd, []):
            return s.rel, s.line
        return next(iter(rp.registry_cmds))[0], 1

    @staticmethod
    def _seeds(rp, cmd):
        # The DISPATCHER fn is excluded: from it, every handler arm is
        # one hop away, so one hook anywhere (serve.admit in
        # _cmd_submit) would vacuously "cover" every dispatched cmd.
        # Coverage must come from THIS cmd's arm delegates or send path;
        # a dispatcher-body hook counts only via _dispatcher_hook (and
        # only when it is cmd-parameterized).
        arms = rp.arm_index.get(cmd, [])
        disp_ids = {id(a.dispatcher.node) for a in arms if a.dispatcher}
        fns = []
        for a in arms:
            fns.extend(a.fns)
        for s in rp.sites_by_cmd.get(cmd, []):
            fns.extend(s.fns)
        out, ids = [], set()
        for fn in fns:
            if id(fn.node) not in ids and id(fn.node) not in disp_ids:
                ids.add(id(fn.node))
                out.append(fn)
        return out

    def _dispatcher_hook(self, rp, cmd) -> bool:
        """A hook in the dispatch loop itself covers every cmd it
        dispatches — but only when parameterized by the cmd (the
        worker's ``faultplan.delay("rpc.delay", cmd=cmd, ...)``): an
        unparameterized dispatcher hook cannot target one cmd, so it
        distinguishes nothing."""
        for a in rp.arm_index.get(cmd, []):
            if a.dispatcher is None or a.dispatcher.rel in \
                    self.exclude_hook_rels:
                continue
            for n in ast.walk(a.dispatcher.node):
                if (
                    isinstance(n, ast.Call)
                    and self._hook_call(n)
                    and any(kw.arg == "cmd" for kw in n.keywords)
                ):
                    return True
        return False

    def _covered(self, program, seeds) -> bool:
        frontier = list(seeds)
        ids = {id(fn.node) for fn in frontier}
        for _ in range(self.hops + 1):
            nxt = []
            for fn in frontier:
                if self._has_hook(fn):
                    return True
                for c in fn.calls:
                    for t in program.graph.resolve(
                        fn.module, c.callee, include_nested=True
                    ):
                        if id(t.node) not in ids:
                            ids.add(id(t.node))
                            nxt.append(t)
            frontier = nxt
            if not frontier:
                break
        return False

    def _has_hook(self, fn) -> bool:
        if fn.rel in self.exclude_hook_rels:
            return False
        return any(
            isinstance(n, ast.Call) and self._hook_call(n)
            for n in ast.walk(fn.node)
        )

    def _hook_call(self, n: ast.Call) -> bool:
        name = call_name(n)
        parts = name.split(".")
        if parts[-1] not in self.hook_names:
            return False
        if len(parts) < 2 or parts[-2] != "faultplan":
            return False
        return (
            bool(n.args)
            and isinstance(n.args[0], ast.Constant)
            and isinstance(n.args[0].value, str)
            and n.args[0].value not in self.generic_sites
        )
