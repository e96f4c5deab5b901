"""Plan optimizer — a rewrite pass between validation and compilation.

Port of ``locust_tpu/plan/optimize.py``.  ``optimize(plan, cfg, mesh)``
runs over a VALIDATED plan and returns an ``Optimized`` bundle: a
(possibly rewritten) plan that is still a valid ``Plan`` plus
annotations the compiler consumes.  The hard contract is byte-identity:
every rewrite must leave the sink-rendered output byte-for-byte what the
naive lowering produces — the rules below only ever (a) rename work onto
an implementation that is already pinned bit-identical, (b) deduplicate
work whose results are equal by content-addressed construction, or (c)
reuse results whose inputs are verified by hash to be a prefix of the
new input.  A plan no rule matches passes through EXACTLY — same object,
same fingerprint.

The rule registry is CLOSED: every rule id is an entry in
``REWRITE_RULES``, and rewrites are recorded through ``record_rewrite``
with a LITERAL rule id — a typo'd rule fails loudly at the firing site.
Static only: eligibility here never probes a device — the ENGINE keeps
runtime authority (an ineligible fused fold degrades inside the engine,
byte-identically).
"""

from __future__ import annotations

import dataclasses
import hashlib

from locust_tpu_torch import obs
from locust_tpu_torch.plan.nodes import Plan, PlanError

# The closed rewrite-rule registry, the JAX package's.
REWRITE_RULES = (
    "fuse_fold_kernel",   # wordcount fold spine -> sort_mode="fused"
    "compose_score",      # single-consumer reduce+tfidf_score: one stage
    "cse_subplan",        # duplicate upstream closures -> one node
    "incremental_fold",   # verified append-only regrowth -> delta refold
)


def record_rewrite(rule: str) -> None:
    """Count one applied rewrite; the rule id must be registered (a
    typo'd id fails at the firing site, not in a dashboard nobody
    reads)."""
    if rule not in REWRITE_RULES:
        raise PlanError(
            f"rewrite rule {rule!r} is not in REWRITE_RULES "
            "(locust_tpu_torch/plan/optimize.py) — register it"
        )
    obs.metric_inc("plan.rewrites")


@dataclasses.dataclass(frozen=True)
class Optimized:
    """One optimizer pass result: the plan to LOWER (identity for
    caches stays the ORIGINAL plan — ``CompiledPlan`` keeps both) plus
    the annotations the compiler consumes."""

    plan: Plan
    applied: tuple = ()            # rule ids fired, in order
    fuse_kernel: bool = False      # wordcount folds build the fused engine
    composed_scores: frozenset = frozenset()  # score node ids folded inline


def optimize(plan: Plan, cfg=None, mesh: bool = False) -> Optimized:
    """Run every static rewrite over ``plan``.  Identity when nothing
    fires: the SAME ``Plan`` object comes back (same fingerprint), so a
    no-op optimization can never perturb cache keys or WAL replay."""
    with obs.span("plan.optimize", plan=plan.fingerprint()):
        applied: list = []
        plan = _cse_subplan(plan, applied)
        composed = _compose_score(plan, applied)
        fuse = _fuse_fold_kernel(plan, cfg, mesh, applied)
        return Optimized(
            plan=plan, applied=tuple(applied),
            fuse_kernel=fuse, composed_scores=composed,
        )


# ------------------------------------------------------------- rule (a)


def _fuse_fold_kernel(plan: Plan, cfg, mesh: bool, applied: list) -> bool:
    """Fusion onto the fused kernel: a ``map(tokenize_count) →
    shuffle(by_key) → reduce(sum)`` spine under ``sort_mode="hasht"``
    lowers its wordcount fold with ``sort_mode="fused"`` instead — the
    whole map→aggregate chain in ONE kernel launch per block
    (``csrc/fused_fold.cu``).  Safe by the pinned family identity
    (``HASHT_FAMILY`` tables are BIT-identical) and because the engine's
    own eligibility check stays the runtime authority: off supported
    shapes it degrades to plain hasht, byte-identically.  Static only —
    this module never probes a device.  The rule fires for ``mesh=True``
    too, as in the JAX package; the port's compiler refuses mesh plans
    until the mesh tier is ported (plan/compile.py)."""
    if cfg is None or getattr(cfg, "sort_mode", None) != "hasht":
        return False
    by_id = plan.by_id()
    for n in plan.nodes:
        if n.kind != "reduce" or n.op != "sum":
            continue
        shuf = by_id[n.inputs[0]]
        if shuf.kind != "shuffle":
            continue
        mapper = by_id[shuf.inputs[0]]
        if mapper.kind == "map" and mapper.op == "tokenize_count":
            record_rewrite("fuse_fold_kernel")
            applied.append("fuse_fold_kernel")
            return True
    return False


# ------------------------------------------------------------- rule (b)


def _compose_score(plan: Plan, applied: list) -> frozenset:
    """Adjacent-map composition, tfidf spine: a ``map(tfidf_score)``
    whose input reduce has EXACTLY one consumer evaluates fold+rescore
    as one stage — the intermediate tf table is consumed inline and
    never retained in the stage memo (one dispatch, no materialized
    intermediate).  Annotation-only: the plan is unchanged, so the
    rendered bytes are trivially identical."""
    by_id = plan.by_id()
    consumers: dict = {}
    for n in plan.nodes:
        for ref in n.inputs:
            consumers[ref] = consumers.get(ref, 0) + 1
    composed = set()
    for n in plan.nodes:
        if n.kind == "map" and n.op == "tfidf_score":
            feed = by_id[n.inputs[0]]
            if feed.kind == "reduce" and consumers.get(feed.id) == 1:
                composed.add(n.id)
    if composed:
        record_rewrite("compose_score")
        applied.append("compose_score")
    return frozenset(composed)


def _cse_subplan(plan: Plan, applied: list) -> Plan:
    """Common-subplan elimination WITHIN a plan: nodes whose upstream
    closures share a content-addressed fingerprint
    (``Plan.node_fingerprint``) collapse onto the first in topo order,
    and every consumer re-points at the survivor — so a join of two
    identical chains folds the chain ONCE.  The rewritten node set goes
    back through full ``Plan`` validation (type-check, arity, topo,
    reachability); results are equal by content-addressed construction,
    so the sink bytes cannot change."""
    by_id = plan.by_id()
    keeper: dict = {}   # closure fp -> surviving node id
    remap: dict = {}    # dropped node id -> surviving node id
    for nid in plan.topo_order():
        if by_id[nid].kind == "sink":
            continue
        fp = plan.node_fingerprint(nid)
        if fp in keeper:
            remap[nid] = keeper[fp]
        else:
            keeper[fp] = nid
    if not remap:
        return plan
    record_rewrite("cse_subplan")
    applied.append("cse_subplan")
    survivors = []
    for n in plan.nodes:
        if n.id in remap:
            continue
        if any(ref in remap for ref in n.inputs):
            n = dataclasses.replace(
                n, inputs=tuple(remap.get(ref, ref) for ref in n.inputs)
            )
        survivors.append(n)
    return Plan(tuple(survivors), version=plan.version)


# ------------------------------------------------------------- rule (c)


def incremental_delta(entry: dict, corpus: bytes) -> dict | None:
    """Append-only regrowth check for one cached fold entry (a sub-plan
    cache such as the JAX package's ``serve.cache.SubPlanCache``): the
    new ``corpus`` qualifies for an
    incremental delta refold iff the entry's corpus is a VERIFIED
    prefix — the sha256 is recomputed over ``corpus[:old_len]`` right
    here, server-side, never trusted from the client — that ends on a
    line boundary (otherwise the delta's first bytes would merge into
    the prefix's last line and re-tokenize it; a ``\\r\\n`` split
    across the cut is the same hazard), and the cached table is exact
    (a truncated table dropped keys nobody can re-derive).  Returns
    ``{"rule": "incremental_fold", "old_len", "old_n_lines"}`` on a
    match — the caller (``plan/compile._RunCtx``) folds ONLY the delta
    lines and merges via the mergeable-table property
    (``engine.merge_host_pairs``), recording the rewrite on success."""
    old_len = int(entry.get("corpus_len") or 0)
    old_sha = entry.get("corpus_sha") or ""
    if not (0 < old_len < len(corpus)):
        return None
    if entry.get("truncated"):
        return None
    if corpus[old_len - 1:old_len] != b"\n":
        return None
    if hashlib.sha256(corpus[:old_len]).hexdigest() != old_sha:
        return None
    return {
        "rule": "incremental_fold",
        "old_len": old_len,
        "old_n_lines": int(entry.get("n_lines") or 0),
    }
