"""Deterministic, seeded fault injection (chaos engineering).

The port's own copy of ``locust_tpu/utils/faultplan.py``: the same
closed registry of sites and actions, the same plan format, the same
``sha256(seed, rule, event)`` determinism (the same plan over the same
event sequence fires the same faults and mangles the same bytes in both
packages), and zero cost when no plan is active.  A seeded plan injects
failures at named sites; the tests assert that a run still produces
byte-identical output or a structured error, never a hang or a silent
wrong answer.

Plan spec (JSON text, a path to a JSON file, or the ``FaultPlan`` API;
CLI: ``--fault-plan`` / ``$LOCUST_FAULT_PLAN``)::

    {"seed": 7, "rules": [
      {"site": "io.ckpt_write", "action": "crash", "times": 1},
      {"site": "io.checkpoint", "action": "truncate", "after": 1}
    ]}

The port fires these sites:

  rpc.connect      master, before every connection (distributor/master.py)
                                                    ctx: host, port
  rpc.frame        every frame sent, JSON and binary, past its 4-byte
                   length prefix (distributor/protocol.py)    ctx: cmd
  rpc.delay        worker, before a command is handled
                                                    ctx: cmd, shard, port
  worker.map       worker, before a map runs        ctx: shard, port
  io.intermediate  worker, a raw fetch window       ctx: path, offset, port
  io.chunk         worker, the encoded payload of a binary fetch reply
                                                    ctx: path, offset, port, enc
  io.checkpoint    engine snapshot just published   ctx: path
  io.ckpt_write    checkpoint writer between the fully written temporary
                   snapshot and its atomic rename (io/snapshot.py)
                                                    ctx: path, generation
  backend.dispatch a fold on the card guarded by the circuit breaker
                   (backend.guarded_dispatch)       ctx: block, backend

  serve.admit      serve daemon admission path      ctx: tenant, workload
  serve.dispatch   serve daemon batch dispatch      ctx: jobs[, job, worker]
  serve.journal    write-ahead journal append       ctx: rec, job
  serve.place      worker pool placement (serve/pool.py)     ctx: key
  serve.ship       WAL shipper, each ship frame (serve/replicate.py)
                                                    ctx: cmd, seq, n
  plan.stage       one distributed-plan stage RPC, at the worker and at
                   the daemon's wave runner
                                          ctx: phase, split, part, port|worker
  plan.partition   each published shuffle partition between the map and
                   reduce waves (plan/distribute.py) ctx: path, split, part

The registry keeps every site of the JAX package, so a plan written for
either package parses in both, and every site fires in the port with the
JAX actions.

Determinism: rule bookkeeping is pure counting (``after`` skips,
``times`` caps), and the probabilistic gate and byte mutations derive
from ``sha256(seed, rule-index, event-index)``.

Zero overhead when no plan is active: every hook is a module-level
function whose first statement returns on ``_PLAN is None``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time

ENV_VAR = "LOCUST_FAULT_PLAN"

# site -> allowed actions.  Closed registry: parse rejects anything else.
SITES = {
    "rpc.connect": ("refuse",),
    "rpc.frame": ("corrupt", "truncate"),
    "rpc.delay": ("delay",),
    "worker.map": ("crash", "error", "delay"),
    "io.intermediate": ("corrupt", "truncate"),
    # The pipelined data plane's wire payload AFTER encoding (zlib or
    # raw): corruption here reaches the master as a zlib error or a
    # chunk-sha mismatch, not an HMAC reject — a distinct failure mode
    # from rpc.frame, which mangles the framed wire bytes.
    "io.chunk": ("corrupt", "truncate", "delay"),
    "io.checkpoint": ("corrupt", "truncate"),
    # The async checkpoint writer's publish point (io/snapshot.py
    # finalize_snapshot): "crash" dies between the fully-written tmp
    # snapshot and its atomic rename (tmp debris, previous generation
    # survives — on the background writer the run continues and the
    # snapshot is abandoned; on a synchronous save the loop thread IS
    # the writer, so it propagates as a structured error); "delay"
    # stalls the writer so the hot loop laps it (latest-wins skips).
    "io.ckpt_write": ("crash", "delay"),
    # Serve tier (locust_tpu/serve/daemon.py; docs/SERVING.md).
    # serve.admit fires at the admission boundary: "error" = the client
    # gets a STRUCTURED rejection (code fault_injected) and may retry;
    # "delay" = admission contention.  ctx: tenant, workload.
    "serve.admit": ("error", "delay"),
    # serve.dispatch fires as a popped batch heads for the engine:
    # "crash"/"error" = the dispatch dies — the retry/bisection ladder
    # (docs/SERVING.md) re-runs survivors and quarantines a poison job,
    # every terminal failure structured (never a silent wrong answer);
    # "delay" = a straggling dispatch.  ctx: jobs (batch size) on the
    # batch-level fire; when no batch rule matches, one sub-fire per
    # job adds job=<job_id> so a plan can target ONE poison job.
    "serve.dispatch": ("crash", "error", "delay"),
    # serve.place fires inside the worker pool's placement decision
    # (serve/pool.py WorkerPool.place): "error" = placement fails and
    # the batch falls back to the daemon's LOCAL engine — the result
    # stays byte-identical, the pool survives; "delay" = a slow
    # placement decision.  ctx: key (affinity key).
    "serve.place": ("error", "delay"),
    # serve.ship fires inside the replication shipper just before a
    # ship/catch-up frame leaves for the standby (serve/replicate.py;
    # docs/SERVING.md "High availability").  Shipping is asynchronous
    # off the admit path, so EVERY action leaves the primary's answers
    # byte-identical: "drop" discards the outgoing batch (the standby
    # sees a sequence gap and converges through a snapshot catch-up),
    # "corrupt" mangles the serialized records (the standby's checksum
    # rejects them — a corrupt record is NEVER applied — and the
    # primary re-syncs), "delay" stalls the shipper (replication lag
    # grows and is reported; admits stay fast).  ctx: cmd, seq, n.
    "serve.ship": ("drop", "corrupt", "delay"),
    # serve.journal fires inside the write-ahead job journal's append
    # (serve/journal.py; docs/SERVING.md): "crash" models the daemon
    # dying mid-append — a TORN record lands on disk and the append
    # raises (the submit is rejected structured, never acked); "corrupt"
    # mangles the record bytes silently (replay must skip the garbage
    # line and recover every other job).  ctx: rec (record type), job.
    "serve.journal": ("crash", "corrupt"),
    # backend.dispatch fires on accelerator dispatches guarded by the
    # circuit breaker (backend.guarded_dispatch): "error" models the
    # accelerator's link dying between probe and dispatch — consecutive
    # failures trip the breaker and the run resumes on the CPU from the
    # last checkpoint; "delay" models a slow link.  ctx: block, backend.
    "backend.dispatch": ("error", "delay"),
    # plan.stage fires at the distributed-plan stage RPC boundary, on
    # BOTH sides (distributor/worker.py _plan_stage and the daemon's
    # _run_plan_stage_rpc; docs/PLAN.md "Distributed execution"):
    # "crash" models the worker SIGKILL'd mid-stage (connection dropped,
    # no reply — the coordinator recomputes the stage on a survivor);
    # "error" a structured stage failure (same recovery); "delay" a
    # straggler the coordinator's speculative backup races.  ctx: phase
    # (map|reduce), split, part, plus port on the worker-side fire and
    # worker on the daemon-side fire.
    "plan.stage": ("crash", "error", "delay"),
    # plan.partition fires between the map and reduce waves on every
    # published shuffle-partition file (plan/distribute.py
    # chaos_partition): "drop" unlinks it (a spill GC race / disk loss
    # mid-plan — the reduce worker's read fails, names the lost_split,
    # and the coordinator recomputes exactly that map split); "corrupt"
    # flips bytes (the sha256 gate rejects the file — same recovery,
    # never a silent wrong answer).  ctx: path, split, part.
    "plan.partition": ("drop", "corrupt"),
}

_RULE_KEYS = {"site", "action", "match", "times", "after", "prob", "delay_s"}


class FaultInjected(RuntimeError):
    """Raised by a site when its matched action is to fail (refuse/error)."""


class FaultCrash(FaultInjected):
    """A worker 'process crash': the daemon drops the connection on the
    floor — no reply, no error frame — exactly what a SIGKILL mid-map
    looks like from the master's side."""


class FaultRule:
    """One (site, action) rule with match filters and firing bookkeeping."""

    def __init__(self, spec: dict, index: int):
        unknown = set(spec) - _RULE_KEYS
        if unknown:
            raise ValueError(f"fault rule {index}: unknown keys {sorted(unknown)}")
        site = spec.get("site")
        if site not in SITES:
            raise ValueError(
                f"fault rule {index}: unknown site {site!r} "
                f"(known: {sorted(SITES)})"
            )
        action = spec.get("action")
        if action not in SITES[site]:
            raise ValueError(
                f"fault rule {index}: action {action!r} invalid for site "
                f"{site!r} (allowed: {SITES[site]})"
            )
        self.site = site
        self.action = action
        self.match = dict(spec.get("match") or {})
        self.times = spec.get("times")  # None = unlimited
        if self.times is not None and int(self.times) < 1:
            raise ValueError(f"fault rule {index}: times must be >= 1 or null")
        self.after = int(spec.get("after") or 0)
        self.prob = float(spec.get("prob", 1.0))
        if not 0.0 < self.prob <= 1.0:
            raise ValueError(f"fault rule {index}: prob must be in (0, 1]")
        self.delay_s = float(spec.get("delay_s") or 0.0)
        if action == "delay" and self.delay_s <= 0.0:
            raise ValueError(f"fault rule {index}: delay action needs delay_s > 0")
        self.index = index
        self.seen = 0   # matching events observed
        self.fired = 0  # faults actually injected

    def matches(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())


class FaultPlan:
    """A seeded set of rules plus thread-safe firing state."""

    def __init__(self, rules: list[dict], seed: int = 0):
        self.seed = int(seed)
        self.rules = [FaultRule(r, i) for i, r in enumerate(rules)]
        self._lock = threading.Lock()

    # ------------------------------------------------------------- parsing

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a plan from JSON text or a path to a JSON file."""
        text = spec.strip()
        if not text.startswith(("{", "[")):
            with open(text) as f:
                text = f.read()
        obj = json.loads(text)
        if isinstance(obj, list):  # bare rule list: seed defaults to 0
            obj = {"rules": obj}
        unknown = set(obj) - {"seed", "rules"}
        if unknown:
            raise ValueError(f"fault plan: unknown keys {sorted(unknown)}")
        return cls(obj.get("rules") or [], seed=obj.get("seed", 0))

    # -------------------------------------------------------------- firing

    def fire(self, site: str, ctx: dict) -> FaultRule | None:
        """First rule for ``site`` matching ``ctx`` that decides to inject;
        bookkeeping (seen/fired counters) advances deterministically."""
        with self._lock:
            for rule in self.rules:
                if rule.site != site or not rule.matches(ctx):
                    continue
                rule.seen += 1
                if rule.seen <= rule.after:
                    continue
                if rule.times is not None and rule.fired >= int(rule.times):
                    continue
                if rule.prob < 1.0 and not self._gate(rule):
                    continue
                rule.fired += 1
                return rule
        return None

    def _gate(self, rule: FaultRule) -> bool:
        """Deterministic pseudo-random gate: same plan + same event order
        -> same decisions (no wall clock, no global RNG state)."""
        h = hashlib.sha256(
            f"{self.seed}:{rule.index}:{rule.seen}".encode()
        ).digest()
        return int.from_bytes(h[:8], "big") < rule.prob * 2.0**64

    def mutate(self, rule: FaultRule, data: bytes, keep_prefix: int = 0) -> bytes:
        """Apply ``corrupt``/``truncate`` to ``data`` deterministically.

        ``corrupt`` XOR-flips a handful of bytes at sha256-derived
        positions; ``truncate`` drops the tail.  ``keep_prefix`` bytes are
        never touched (e.g. a frame's length header — corrupting the
        length would model a different fault: an arbitrarily long stall
        bounded only by socket timeouts, which the delay action covers
        on purpose instead of by accident).
        """
        body = data[keep_prefix:]
        if not body:
            return data
        h = hashlib.sha256(
            f"{self.seed}:{rule.index}:{rule.fired}:mutate".encode()
        ).digest()
        if rule.action == "truncate":
            # Keep a strict prefix: at least 0, at most len-1 bytes.
            cut = int.from_bytes(h[:4], "big") % len(body)
            return data[: keep_prefix + cut]
        flips = max(1, len(body) // 256)
        out = bytearray(data)
        for i in range(flips):
            pos = int.from_bytes(h[4 * i % 28 : 4 * i % 28 + 4], "big") % len(body)
            out[keep_prefix + pos] ^= 0x01 + (h[(i + 3) % 32] % 255)
        return bytes(out)

    def summary(self) -> str:
        return "; ".join(
            f"{r.site}/{r.action}x{r.times if r.times is not None else '*'}"
            f"(fired {r.fired})"
            for r in self.rules
        )


# ----------------------------------------------------------------- activation

_PLAN: FaultPlan | None = None


def active() -> FaultPlan | None:
    return _PLAN


def activate(plan: FaultPlan | None) -> None:
    global _PLAN
    _PLAN = plan


def deactivate() -> None:
    activate(None)


@contextlib.contextmanager
def active_plan(plan: FaultPlan):
    """Scoped activation for tests: always deactivates, even on failure."""
    prev = _PLAN
    activate(plan)
    try:
        yield plan
    finally:
        activate(prev)


def install(spec: str | None = None, env_var: str = ENV_VAR) -> FaultPlan | None:
    """Activate a plan from an explicit spec (JSON/path) or ``$LOCUST_FAULT_PLAN``.

    Returns the activated plan (None if neither source is set).  Parse
    errors raise — an operator who asked for chaos must get the chaos
    they spelled, not a silently fault-free run.
    """
    spec = spec or os.environ.get(env_var)
    if not spec:
        return None
    plan = FaultPlan.parse(spec)
    activate(plan)
    return plan


# ------------------------------------------------------------------ site hooks
#
# Each hook's first statement bails when no plan is active — the zero-
# overhead contract.  Call sites stay one line.


def _note(site: str, rule: FaultRule) -> None:
    """Telemetry: an injected fault becomes an instant event on the
    active trace (+ a counter), so chaos runs debug as timelines
    (docs/OBSERVABILITY.md).  Reached only when a rule FIRED — a run
    with no plan (or no matching rule) never pays this call."""
    from locust_tpu_torch import obs

    obs.event("fault.injected", site=site, action=rule.action,
              rule=rule.index, fired=rule.fired)
    obs.metric_inc("fault.injections")


def fire(site: str, **ctx) -> FaultRule | None:
    """Generic hook: the matched-and-armed rule, or None.  Sites with
    bespoke behavior (worker.map) branch on the returned rule.action."""
    if _PLAN is None:
        return None
    rule = _PLAN.fire(site, ctx)
    if rule is not None:
        _note(site, rule)
    return rule


def check_connect(host: str, port: int) -> None:
    """rpc.connect: raise ConnectionRefusedError as if nothing listened."""
    if _PLAN is None:
        return
    rule = _PLAN.fire("rpc.connect", {"host": host, "port": port})
    if rule is not None:
        _note("rpc.connect", rule)
        raise ConnectionRefusedError(
            f"[faultplan] injected connect refusal to {host}:{port}"
        )


def mangle(site: str, data: bytes, keep_prefix: int = 0, **ctx) -> bytes:
    """rpc.frame / io.intermediate: corrupt or truncate a byte payload."""
    if _PLAN is None:
        return data
    rule = _PLAN.fire(site, ctx)
    if rule is None:
        return data
    _note(site, rule)
    return _PLAN.mutate(rule, data, keep_prefix=keep_prefix)


def delay(site: str, **ctx) -> None:
    """rpc.delay (and delay-action rules on other sites): sleep in place —
    the straggler model.  Bounded by the rule's own delay_s; the caller's
    socket timeouts bound what the PEER observes."""
    if _PLAN is None:
        return
    rule = _PLAN.fire(site, ctx)
    if rule is not None and rule.delay_s > 0:
        _note(site, rule)
        time.sleep(rule.delay_s)


def damage_file(site: str, path: str, **ctx) -> None:
    """io.checkpoint: corrupt/truncate a just-written file in place."""
    if _PLAN is None:
        return
    rule = _PLAN.fire(site, dict(ctx, path=path))
    if rule is None:
        return
    _note(site, rule)
    try:
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(_PLAN.mutate(rule, data))
    except OSError:
        pass  # the file vanished; the fault is moot
