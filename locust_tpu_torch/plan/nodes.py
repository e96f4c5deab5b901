"""Typed logical dataflow plans: the DAG layer over the engine.

Port of ``locust_tpu/plan/nodes.py``.  A *plan* is a small, deferred,
fingerprintable DAG of typed logical nodes that ``plan/compile.py``
lowers onto the engine and the apps (the reference's one hand-wired
Map→Process→Reduce sequence, reference MapReduce/src/main.cu:397-473, as
one case of it).  A ``Plan`` is pure data with a content-addressed
``fingerprint()`` in the same sha-of-canonical-repr mold as
``EngineConfig.fingerprint()``; ``canonical_json``, ``fingerprint`` and
``node_fingerprint`` are byte-identical to the JAX package's, so a cache
or journal keyed by either package names the same plan
(tests/test_torch_plan.py).

Closed registries:

  * ``NODE_KINDS`` — the node kinds a plan may use; an unknown kind is a
    loud ``PlanError`` at construction, never a silently-ignored node;
  * ``NODE_OPS`` — the operations each kind admits;
  * ``_SIGNATURES`` — the dataflow TYPE each (kind, op) consumes and
    produces; validation type-checks the whole DAG in topological order,
    so a plan that wires a token stream into a ranks sink fails at
    construction, not at run time.

Imports the standard library only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re

PLAN_VERSION = 1

# The closed node-kind registry.
NODE_KINDS = (
    "source",   # ingest: corpus text or an edge list
    "map",      # per-record transform / emit (or a table-level rescore)
    "shuffle",  # group records by key (the Process-stage sort)
    "reduce",   # combine each group into one row
    "join",     # inner-join two tables on key
    "iterate",  # a fixed-point loop over a static structure
    "sink",     # render the terminal table to output bytes
)

# Operations per kind — the second closed tier under the kind registry.
NODE_OPS = {
    "source": ("text", "edges"),
    "map": ("tokenize_count", "tokenize_pairs", "tfidf_score"),
    "shuffle": ("by_key",),
    "reduce": ("sum", "collect_docs"),
    "join": ("inner",),
    "iterate": ("pagerank",),
    "sink": ("table", "tfidf", "postings", "ranks"),
}

# Dataflow typing: (kind, op) -> [(input types, output type), ...].
# Polymorphic ops (shuffle/reduce over word emits vs (word, doc) pair
# emits) list one signature per accepted input row type; validation
# picks the matching one in topological order.
_SIGNATURES = {
    ("source", "text"): (((), "rows"),),
    ("source", "edges"): (((), "edges"),),
    ("map", "tokenize_count"): ((("rows",), "emits"),),
    ("map", "tokenize_pairs"): ((("rows",), "pair_emits"),),
    ("map", "tfidf_score"): ((("pair_table",), "scores"),),
    ("shuffle", "by_key"): (
        (("emits",), "grouped"),
        (("pair_emits",), "grouped_pairs"),
    ),
    ("reduce", "sum"): (
        (("grouped",), "table"),
        (("grouped_pairs",), "pair_table"),
    ),
    ("reduce", "collect_docs"): ((("grouped_pairs",), "postings"),),
    ("join", "inner"): ((("table", "table"), "table"),),
    ("iterate", "pagerank"): ((("edges",), "ranks"),),
    ("sink", "table"): ((("table",), "output"),),
    ("sink", "tfidf"): ((("scores",), "output"),),
    ("sink", "postings"): ((("postings",), "output"),),
    ("sink", "ranks"): ((("ranks",), "output"),),
}

# Per-(kind, op) parameter schema: name -> validator returning the
# normalized value or raising ValueError.  A key outside the schema is a
# loud PlanError (the SPEC_CONFIG_KEYS stance: typos never silently
# no-op).  Every value must be a JSON scalar so plans round-trip.
JOIN_COMBINES = ("sum", "mul", "min")


def _pos_int(v):
    if isinstance(v, bool) or not isinstance(v, int) or v < 1:
        raise ValueError(f"must be an integer >= 1, got {v!r}")
    return v


# Iteration budget cap: a plan is multi-tenant input on the JAX package's
# serve tier, and an unbounded num_iters would hold a server's engine for
# hours on a validated submit.  Far above any convergent power-iteration
# use (the reference default is 20).
MAX_ITERS = 10_000


def _iters(v):
    v = _pos_int(v)
    if v > MAX_ITERS:
        raise ValueError(f"must be <= {MAX_ITERS}, got {v}")
    return v


def _damping(v):
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        raise ValueError(f"must be a number, got {v!r}")
    v = float(v)
    if not 0.0 < v < 1.0:
        raise ValueError(f"must be in (0, 1), got {v}")
    return v


def _input_name(v):
    if not isinstance(v, str) or not _ID_RE.match(v):
        raise ValueError(f"must be a short identifier, got {v!r}")
    return v


def _join_combine(v):
    if v not in JOIN_COMBINES:
        raise ValueError(f"must be one of {JOIN_COMBINES}, got {v!r}")
    return v


_PARAM_SCHEMA = {
    ("source", "text"): {"lines_per_doc": _pos_int, "input": _input_name},
    ("source", "edges"): {"input": _input_name},
    ("join", "inner"): {"combine": _join_combine},
    ("iterate", "pagerank"): {"num_iters": _iters, "damping": _damping},
}

_ID_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")

# Arity per kind (join is the one two-input node).
_ARITY = {
    "source": 0, "map": 1, "shuffle": 1, "reduce": 1, "join": 2,
    "iterate": 1, "sink": 1,
}


class PlanError(ValueError):
    """Structured plan validation failure (the JAX serve tier maps it
    onto its ``bad_spec`` reason code)."""


@dataclasses.dataclass(frozen=True)
class Node:
    """One typed plan node.  ``params`` is a sorted key/value tuple so
    the dataclass stays frozen + hashable; build through ``node()``."""

    id: str
    kind: str
    op: str
    inputs: tuple = ()
    params: tuple = ()

    def param(self, name: str, default=None):
        for k, v in self.params:
            if k == name:
                return v
        return default


def node(node_id: str, kind: str, op: str, inputs=(), **params) -> Node:
    """Node constructor: the kind is a literal second argument here (or
    a ``kind=`` keyword), never a runtime-built string."""
    return Node(
        id=str(node_id), kind=kind, op=op,
        inputs=tuple(str(i) for i in inputs),
        params=tuple(sorted(params.items())),
    )


@dataclasses.dataclass(frozen=True)
class Plan:
    """A validated logical dataflow DAG.

    Validation runs in ``__post_init__`` (the ``EngineConfig`` stance):
    every ``Plan`` instance is structurally valid by construction —
    unique ids, registered kinds/ops, arity, acyclicity, full dataflow
    type-check, exactly one sink, no orphan nodes.  ``fingerprint()`` is
    content-addressed over the canonical JSON, so "same plan" is ONE
    well-defined predicate shared by the warm-executable cache, the
    result cache and journal replay.
    """

    nodes: tuple = ()
    version: int = PLAN_VERSION

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(self.nodes))
        _validate(self)

    # ------------------------------------------------------------ identity

    def to_doc(self) -> dict:
        return {
            "plan_version": self.version,
            "nodes": [
                {
                    "id": n.id, "kind": n.kind, "op": n.op,
                    "inputs": list(n.inputs),
                    "params": dict(n.params),
                }
                for n in self.nodes
            ],
        }

    def canonical_json(self) -> str:
        """The ONE serialized spelling: sorted keys, no whitespace.
        ``fingerprint()`` hashes exactly this text, and the serve tier
        stores exactly this text in ``JobSpec.plan`` and the journal —
        so 'same plan' can never depend on dict ordering."""
        return json.dumps(self.to_doc(), sort_keys=True,
                          separators=(",", ":"))

    def fingerprint(self) -> str:
        """sha1 of the canonical JSON, truncated like
        ``EngineConfig.fingerprint()`` — the plan half of the serve
        tier's executable identity.  Memoized: the scheduler keys
        pending jobs by it every poll tick."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            fp = hashlib.sha1(
                self.canonical_json().encode()
            ).hexdigest()[:12]
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    def node_fingerprint(self, nid: str) -> str:
        """Content-addressed fingerprint of ``nid``'s upstream CLOSURE —
        a Merkle hash over (kind, op, params, input closure fps), so it
        is independent of node IDS and of unrelated siblings: two
        tenants' plans that spell the same tokenize→fold prefix under
        different names share the fingerprint (alpha-equivalence).  The
        optimizer's CSE rewrite and the serve tier's sub-plan result
        cache key on exactly this identity (docs/PLAN.md "Optimizer").
        Memoized like ``fingerprint()`` — one topo sweep per plan."""
        fps = self.__dict__.get("_node_fps")
        if fps is None:
            fps = {}
            by_id = self.by_id()
            for oid in self.topo_order():
                n = by_id[oid]
                payload = json.dumps(
                    [n.kind, n.op, list(n.params),
                     [fps[ref] for ref in n.inputs]],
                    sort_keys=True, separators=(",", ":"),
                )
                fps[oid] = hashlib.sha1(
                    payload.encode()
                ).hexdigest()[:12]
            object.__setattr__(self, "_node_fps", fps)
        if nid not in fps:
            raise PlanError(f"no node {nid!r} in this plan")
        return fps[nid]

    # ---------------------------------------------------------- structure

    def by_id(self) -> dict:
        return {n.id: n for n in self.nodes}

    def sink(self) -> Node:
        return next(n for n in self.nodes if n.kind == "sink")

    def topo_order(self) -> tuple:
        """Node ids in a deterministic topological order (validation
        proved one exists)."""
        return self.__dict__["_topo"]

    def node_types(self) -> dict:
        """{node id: inferred dataflow type} from validation."""
        return dict(self.__dict__["_types"])


def from_doc(doc) -> Plan:
    """Parse + validate a plan document (the JSON dict shape
    ``to_doc()`` emits).  Every malformation is a ``PlanError`` whose
    message is safe to relay to a client."""
    if not isinstance(doc, dict):
        raise PlanError(f"plan must be a JSON object, got {type(doc).__name__}")
    version = doc.get("plan_version")
    if version != PLAN_VERSION:
        raise PlanError(
            f"unsupported plan_version {version!r} (this build speaks "
            f"{PLAN_VERSION})"
        )
    raw_nodes = doc.get("nodes")
    if not isinstance(raw_nodes, list) or not raw_nodes:
        raise PlanError("plan needs a non-empty 'nodes' list")
    nodes = []
    for i, rn in enumerate(raw_nodes):
        if not isinstance(rn, dict):
            raise PlanError(f"nodes[{i}] must be an object")
        unknown = set(rn) - {"id", "kind", "op", "inputs", "params"}
        if unknown:
            raise PlanError(f"nodes[{i}] has unknown keys {sorted(unknown)}")
        inputs = rn.get("inputs", [])
        if not isinstance(inputs, list):
            raise PlanError(f"nodes[{i}].inputs must be a list")
        params = rn.get("params", {})
        if not isinstance(params, dict):
            raise PlanError(f"nodes[{i}].params must be an object")
        # Param keys collide with node()'s own arguments ("kind", "op",
        # ...) as a raw TypeError through **params — every malformation
        # must surface as a structured PlanError, so screen them here;
        # real schema validation still happens in _validate.
        bad = [k for k in params if not isinstance(k, str)
               or k in ("node_id", "kind", "op", "inputs")]
        if bad:
            raise PlanError(
                f"nodes[{i}].params has reserved/invalid keys {bad}"
            )
        nodes.append(node(
            str(rn.get("id", "")), str(rn.get("kind", "")),
            str(rn.get("op", "")), inputs, **params,
        ))
    return Plan(tuple(nodes))


def from_json(text: str) -> Plan:
    try:
        doc = json.loads(text)
    except (TypeError, ValueError) as e:
        raise PlanError(f"plan JSON does not parse: {e}")
    return from_doc(doc)


# ------------------------------------------------------------- validation


def _validate(plan: Plan) -> None:
    nodes = plan.nodes
    if plan.version != PLAN_VERSION:
        raise PlanError(
            f"unsupported plan_version {plan.version!r} (this build "
            f"speaks {PLAN_VERSION})"
        )
    if not nodes:
        raise PlanError("plan needs at least one node")
    seen: dict[str, Node] = {}
    for n in nodes:
        if not isinstance(n, Node):
            raise PlanError(f"plan nodes must be Node instances, got {n!r}")
        if not _ID_RE.match(n.id):
            raise PlanError(f"node id {n.id!r} is not a short identifier")
        if n.id in seen:
            raise PlanError(f"duplicate node id {n.id!r}")
        if n.kind not in NODE_KINDS:
            raise PlanError(
                f"node {n.id!r}: unknown kind {n.kind!r} "
                f"(kinds: {NODE_KINDS})"
            )
        if n.op not in NODE_OPS[n.kind]:
            raise PlanError(
                f"node {n.id!r}: unknown op {n.op!r} for kind {n.kind!r} "
                f"(ops: {NODE_OPS[n.kind]})"
            )
        if len(n.inputs) != _ARITY[n.kind]:
            raise PlanError(
                f"node {n.id!r}: kind {n.kind!r} takes {_ARITY[n.kind]} "
                f"input(s), got {len(n.inputs)}"
            )
        schema = _PARAM_SCHEMA.get((n.kind, n.op), {})
        for k, v in n.params:
            if k not in schema:
                raise PlanError(
                    f"node {n.id!r}: unknown param {k!r} for "
                    f"({n.kind}, {n.op}) (allowed: {sorted(schema) or 'none'})"
                )
            try:
                schema[k](v)
            except ValueError as e:
                raise PlanError(f"node {n.id!r}: param {k!r} {e}")
        seen[n.id] = n
    for n in nodes:
        for ref in n.inputs:
            if ref not in seen:
                raise PlanError(
                    f"node {n.id!r}: input {ref!r} names no node"
                )
            if ref == n.id:
                raise PlanError(f"node {n.id!r}: self-referential input")

    # Kahn topological order — a leftover node means a cycle.
    indeg = {n.id: len(n.inputs) for n in nodes}
    consumers: dict[str, list[str]] = {n.id: [] for n in nodes}
    for n in nodes:
        for ref in n.inputs:
            consumers[ref].append(n.id)
    ready = sorted(nid for nid, d in indeg.items() if d == 0)
    topo: list[str] = []
    while ready:
        nid = ready.pop(0)
        topo.append(nid)
        for c in consumers[nid]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
        ready.sort()
    if len(topo) != len(nodes):
        cyc = sorted(nid for nid, d in indeg.items() if d > 0)
        raise PlanError(f"plan has a cycle through {cyc}")

    # Dataflow type-check in topo order (the "typed" in typed plans).
    types: dict[str, str] = {}
    for nid in topo:
        n = seen[nid]
        in_types = tuple(types[ref] for ref in n.inputs)
        for want, out in _SIGNATURES[(n.kind, n.op)]:
            if in_types == want:
                types[nid] = out
                break
        else:
            raise PlanError(
                f"node {n.id!r}: ({n.kind}, {n.op}) cannot consume "
                f"{in_types} (accepts: "
                f"{[w for w, _ in _SIGNATURES[(n.kind, n.op)]]})"
            )

    sinks = [n for n in nodes if n.kind == "sink"]
    if len(sinks) != 1:
        raise PlanError(f"plan needs exactly one sink node, got {len(sinks)}")

    # Reachability: every node must feed the sink (an orphan subgraph
    # would silently compute nothing — loud instead).
    live = {sinks[0].id}
    frontier = [sinks[0].id]
    while frontier:
        nid = frontier.pop()
        for ref in seen[nid].inputs:
            if ref not in live:
                live.add(ref)
                frontier.append(ref)
    orphans = sorted(set(seen) - live)
    if orphans:
        raise PlanError(f"nodes {orphans} do not feed the sink")

    object.__setattr__(plan, "_topo", tuple(topo))
    object.__setattr__(plan, "_types", types)
