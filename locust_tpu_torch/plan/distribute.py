"""Distributed plan execution: stage programs + shuffle partitions.

The port's copy of the JAX package's ``plan/distribute.py``: the same
shapes, the same partitioner and the same partition files, byte for
byte, so a plan's stages may run on workers of either package.  Pool
dispatch shards *wordcount* batches across workers; this module does the
same for *plan* jobs, the Dean & Ghemawat answer applied to the plan
layer (docs/PLAN.md "Distributed execution"):

  * ``plan_shape()`` recognizes every distributable plan shape and
    returns ``(shape, reason)``: the map->shuffle->reduce[->score]->sink
    fold spine (``StageShape``, the same closed ``_FOLDS`` table
    ``plan/compile.py`` lowers), join trees of wordcount spines
    (``JoinShape`` — the distributed hash-join: co-partitioned bins,
    per-worker tree evaluation), and the pagerank ``iterate`` loop
    (``IterateShape`` — epoch-synchronized rank-shard sweeps).
    Anything else stays on the solo path, byte-identical by refusal,
    and ``reason`` names exactly why (the demotion log / counter and
    the tests read it; ``None`` shape always carries a reason).  Kinds
    that are distribution-exempt BY DESIGN live in the ``SOLO_ONLY``
    registry — analysis rule R014 enforces two-sided that every
    ``NODE_KINDS`` entry is either matched here or listed there, so a
    new kind can never silently stay undistributed;
  * **stage programs**: source splits ride the content-addressed corpus
    spill, each map split folds on a worker's warm executables, and the
    shuffle edge moves keyed partitions worker-to-worker over the
    distributor's binary HMAC'd data plane as packed LKVB files
    (io/serde.py) instead of folding through one merge on the daemon;
  * **deterministic re-execution**: a stage attempt's outputs publish
    ATOMICALLY (tmp + rename into the spill dir, content-addressed by
    sha256 and keyed by (plan fp, split, partition, attempt)), so a
    dead worker's lost shuffle partitions recompute from their durable
    upstream inputs — never a wrong answer, never a full-plan restart;
  * ``finalize()`` folds the reduced partitions back into the EXACT
    bytes the solo path renders (``compile.iter_rendered`` is the one
    spelling of every sink format) — byte-identity is the contract
    throughout.

Chaos: the ``plan.partition`` site fires between the map and reduce
waves on every published partition file ("drop" unlinks it — the reduce
worker's sha/parse check fails structured and the coordinator recomputes
the split; "corrupt" flips bytes — same recovery, the checksum is the
tripwire).  ``plan.stage`` (hooked in distributor/worker.py) models the
stage RPC itself dying.  Telemetry: ``plan.partition_bytes`` counts
published shuffle bytes (closed obs registry, R009).

torch-free at import like the rest of the plan/serve control plane: the
fold, render and serde imports are lazy, so recognizing shapes and
keying partitions never pays torch's import.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

from locust_tpu_torch import obs
from locust_tpu_torch.utils import faultplan

from .compile import _FOLDS
from .nodes import Plan

# Node kinds that are distribution-exempt BY DESIGN (R014's two-sided
# distributed-coverage check: every NODE_KINDS entry must either appear
# in a ``.kind`` match below or be listed here with a reason).  Empty
# today: every kind participates in at least one distributed shape —
# source/map/shuffle/reduce as the fold spine, join as the hash-join
# tree, iterate as the epoch sweep, sink as the terminal render.
SOLO_ONLY: tuple = ()

# Doc-id suffix budget for composite (word, doc) partition keys: the doc
# id rides a uint32 key lane (apps/tfidf.py), so <= 10 decimal digits
# plus the NUL separator.
_DOC_SUFFIX = 11

# The one key/doc separator for composite shuffle keys.  Safe by
# construction: NUL is a tokenizer delimiter (config.DELIMITERS), so no
# word ever contains it, and the decimal doc-id suffix keeps read_kvbin's
# trailing-NUL strip away from the separator.
PAIR_SEP = b"\x00"


@dataclasses.dataclass(frozen=True)
class StageShape:
    """The distributable fold spine of a validated plan: which engine
    fold the map+reduce pair lowers to, how source lines map to doc
    ids, whether a tfidf_score stage follows the fold, and the sink op
    that renders the final table."""

    fold: str           # "wordcount" | "tf" | "index" (compile._FOLDS)
    lines_per_doc: int  # source param (doc ids are GLOBAL line//k)
    score: bool         # a map/tfidf_score stage between reduce and sink
    sink_op: str        # "table" | "tfidf" | "postings"
    node_fp: str = ""   # closure fp of the reduce node (warm-cache key)


@dataclasses.dataclass(frozen=True)
class FoldLeaf:
    """One wordcount fold spine feeding a join tree (the only leaf type
    the ``join`` signature admits: its inputs are "table"s, and only
    (tokenize_count, sum) over corpus text produces one)."""

    lines_per_doc: int
    node_fp: str    # closure fp of the leaf's reduce node
    reduce_id: str


@dataclasses.dataclass(frozen=True)
class JoinTree:
    """One ``join`` node in a recognized tree: combine op + children
    (each a FoldLeaf or a deeper JoinTree — depth is unbounded, the
    whole tree evaluates per-bin on one worker without returning to
    the master)."""

    combine: str            # "sum" | "mul" | "min" (nodes.JOIN_COMBINES)
    left: object            # FoldLeaf | JoinTree
    right: object           # FoldLeaf | JoinTree


@dataclasses.dataclass(frozen=True)
class JoinShape:
    """A distributable join plan: a tree of inner-joins over wordcount
    fold leaves.  Executes as ONE shared map wave (every leaf is the
    same corpus wordcount fold, so alpha-equivalent leaves share their
    shuffle partitions) plus one join wave that co-partitions by key
    hash and evaluates the whole tree per bin."""

    tree: JoinTree
    leaves: tuple           # distinct FoldLeafs, deterministic order
    sink_op: str            # "table" (the join signature's output)
    depth: int              # join nodes on the longest root->leaf path


@dataclasses.dataclass(frozen=True)
class IterateShape:
    """A distributable pagerank plan: epoch-synchronized sweeps over
    per-worker rank shards, one rank shuffle per iteration."""

    num_iters: int
    damping: float          # traced f32 on device (bit-parity w/ solo)
    node_fp: str            # closure fp of the iterate node
    sink_op: str            # "ranks"


def _fold_spine(plan, by_id, reducer, seen: set):
    """Recognize reduce<-shuffle<-map<-source(text, corpus) ending at
    ``reducer``; returns (fold name, source node, None) or
    (None, None, reason).  ``seen`` collects the spine's node ids for
    the caller's whole-plan coverage check."""
    shuffle = by_id[reducer.inputs[0]]
    if shuffle.kind != "shuffle":
        return None, None, "fold_feed_not_shuffle"
    mapper = by_id[shuffle.inputs[0]]
    if mapper.kind != "map":
        return None, None, "shuffle_feed_not_map"
    src = by_id[mapper.inputs[0]]
    if src.kind != "source" or src.op != "text":
        return None, None, "source_not_corpus_text"
    if src.param("input", "corpus") != "corpus":
        return None, None, "source_named_input"
    fold = _FOLDS.get((mapper.op, reducer.op))
    if fold is None:
        return None, None, "unlowered_fold"
    seen.update((reducer.id, shuffle.id, mapper.id, src.id))
    return fold, src, None


def _join_tree(plan, by_id, nid: str, seen: set, memo: dict):
    """Walk a join tree rooted at ``nid``: every internal node an
    inner-join, every leaf a wordcount fold spine.  Shared sub-trees
    (CSE'd plans) memoize by node id.  Returns (tree, None) or
    (None, reason)."""
    if nid in memo:
        return memo[nid], None
    node = by_id[nid]
    if node.kind == "join":
        left, reason = _join_tree(plan, by_id, node.inputs[0], seen, memo)
        if left is None:
            return None, reason
        right, reason = _join_tree(plan, by_id, node.inputs[1], seen, memo)
        if right is None:
            return None, reason
        seen.add(node.id)
        out = JoinTree(
            combine=node.param("combine", "sum"), left=left, right=right
        )
    elif node.kind == "reduce":
        fold, src, reason = _fold_spine(plan, by_id, node, seen)
        if fold is None:
            return None, reason
        if fold != "wordcount":
            # Typing already forces this (join inputs are "table"s and
            # only the wordcount fold makes one) — belt for the check.
            return None, "join_leaf_not_wordcount"
        out = FoldLeaf(
            lines_per_doc=int(src.param("lines_per_doc", 1)),
            node_fp=plan.node_fingerprint(node.id),
            reduce_id=node.id,
        )
    else:
        return None, "join_input_not_fold_or_join"
    memo[nid] = out
    return out, None


def _tree_depth(tree) -> int:
    if isinstance(tree, FoldLeaf):
        return 0
    return 1 + max(_tree_depth(tree.left), _tree_depth(tree.right))


def _tree_leaves(tree, out: list) -> list:
    if isinstance(tree, FoldLeaf):
        if tree not in out:
            out.append(tree)
    else:
        _tree_leaves(tree.left, out)
        _tree_leaves(tree.right, out)
    return out


def plan_shape(plan: Plan):
    """Recognize a plan's distributable shape.

    Returns ``(shape, reason)``: shape is a StageShape / JoinShape /
    IterateShape and reason is None, or shape is None and reason is a
    short stable string naming WHY the plan stays on the solo engine
    (multi-consumer DAGs, named inputs, unlowered folds...).  The solo
    path is the correctness floor and refusal here can never change an
    answer — but it is never silent: the daemon logs the reason once
    per shape and counts it (``plan_solo_fallbacks``).
    """
    by_id = plan.by_id()
    try:
        sink = next(n for n in plan.nodes if n.kind == "sink")
    except StopIteration:  # pragma: no cover - validation owns this
        return None, "no_sink"
    child = by_id[sink.inputs[0]]

    if child.kind == "iterate":
        if child.op != "pagerank":  # pragma: no cover - closed NODE_OPS
            return None, "iterate_op_uncovered"
        src = by_id[child.inputs[0]]
        if src.kind != "source" or src.op != "edges":
            return None, "iterate_source_not_edges"
        if src.param("input", "corpus") != "corpus":
            return None, "source_named_input"
        if sink.op != "ranks":  # pragma: no cover - typing owns this
            return None, "iterate_sink_not_ranks"
        if len(plan.nodes) != 3:
            return None, "extra_nodes"
        return IterateShape(
            num_iters=int(child.param("num_iters", 20)),
            damping=float(child.param("damping", 0.85)),
            node_fp=plan.node_fingerprint(child.id),
            sink_op=sink.op,
        ), None

    if child.kind == "join":
        if sink.op != "table":  # pragma: no cover - typing owns this
            return None, "join_sink_not_table"
        seen: set = {sink.id}
        tree, reason = _join_tree(plan, by_id, child.id, seen, {})
        if tree is None:
            return None, reason
        if seen != set(by_id):
            # Extra consumers hanging off the tree (a tee re-reading a
            # leaf table) would change what the join wave must produce.
            return None, "extra_nodes"
        return JoinShape(
            tree=tree,
            leaves=tuple(_tree_leaves(tree, [])),
            sink_op=sink.op,
            depth=_tree_depth(tree),
        ), None

    n_expected = 5
    score = False
    if child.kind == "map" and child.op == "tfidf_score":
        score = True
        n_expected += 1
        child = by_id[child.inputs[0]]
    if child.kind != "reduce":
        return None, "sink_feed_not_reduce"
    reducer = child
    seen = set()
    fold, src, reason = _fold_spine(plan, by_id, reducer, seen)
    if fold is None:
        return None, reason
    # Exact node count rejects extra consumers hanging off the spine
    # (a second sink is impossible, but a join/tee re-reading the table
    # would change what the distributed fold must produce).
    if len(plan.nodes) != n_expected:
        return None, "extra_nodes"
    if (fold, score, sink.op) not in (
        ("wordcount", False, "table"),
        ("tf", True, "tfidf"),
        ("index", False, "postings"),
    ):
        return None, "uncovered_sink_combo"
    return StageShape(
        fold=fold,
        lines_per_doc=int(src.param("lines_per_doc", 1)),
        score=score,
        sink_op=sink.op,
        node_fp=plan.node_fingerprint(reducer.id),
    ), None


# ------------------------------------------------------- shuffle keying


def partition_of(key: bytes, n_parts: int) -> int:
    """Deterministic shuffle partitioner: sha256-derived so replays and
    recomputes route every key to the same partition on every host (the
    stable_shard_id stance — chaos plans and re-executions agree)."""
    h = hashlib.sha256(key).digest()
    return int.from_bytes(h[:8], "big") % n_parts


def encode_key(fold: str, key) -> bytes:
    """One wire spelling of a shuffle key: raw word bytes for the
    wordcount fold, ``word NUL decimal-doc-id`` for the composite
    (word, doc) folds."""
    if fold == "wordcount":
        return key
    word, doc = key
    return word + PAIR_SEP + str(int(doc)).encode()


def decode_key(fold: str, raw: bytes):
    if fold == "wordcount":
        return raw
    word, _, doc = raw.rpartition(PAIR_SEP)
    return word, int(doc)


def partition_key_width(cfg, fold: str) -> int:
    """LKVB row width for a fold's encoded keys: engine words are
    already truncated to ``cfg.key_width``; composite keys append the
    NUL + doc-id suffix."""
    if fold == "wordcount":
        return int(cfg.key_width)
    return int(cfg.key_width) + _DOC_SUFFIX


# -------------------------------------------------- partition publish/read


def partition_path(
    out_dir: str, plan_fp: str, split: int, part: int, attempt: int
) -> str:
    """The content-addressed spill name for one stage attempt's output
    partition — (plan fp, split, partition, attempt) is the identity, so
    a speculative backup attempt can never clobber the primary's file."""
    return os.path.join(
        out_dir, f"plan_{plan_fp}_s{split}_p{part}_a{attempt}.kvb"
    )


def publish_partition(path: str, pairs: list) -> dict:
    """Atomically publish one partition file (tmp + rename, the corpus
    spill's own discipline) and return its durable reference: path,
    sha256 over the serialized bytes, sizes.  ``pairs`` are
    (encoded key bytes, int count) tuples."""
    from locust_tpu_torch.io import serde

    tmp = f"{path}.tmp.{os.getpid()}"
    serde.write_kvbin(pairs, tmp)
    with open(tmp, "rb") as f:
        data = f.read()
    os.replace(tmp, path)
    obs.metric_inc("plan.partition_bytes", len(data))
    return {
        "path": path,
        "sha256": hashlib.sha256(data).hexdigest(),
        "bytes": len(data),
        "pairs": len(pairs),
    }


def publish_split(
    out_dir: str, plan_fp: str, split: int, attempt: int,
    pairs: list, n_parts: int,
) -> list[dict]:
    """Bucket one map split's encoded pairs by partition and publish all
    ``n_parts`` partition files (empty ones included: a missing file and
    an empty partition must stay distinguishable — absence means LOSS)."""
    buckets: list[list] = [[] for _ in range(n_parts)]
    for key, value in pairs:
        buckets[partition_of(key, n_parts)].append((key, int(value)))
    out = []
    for part, bucket in enumerate(buckets):
        ref = publish_partition(
            partition_path(out_dir, plan_fp, split, part, attempt), bucket
        )
        ref["part"] = part
        out.append(ref)
    return out


def read_partition(path: str, expect_sha: str, key_width: int) -> list:
    """Read + verify one published partition: sha256 gate first (a
    corrupt or torn file is a structured loss, never a silent wrong
    answer), then the LKVB decode.  Raises ``ValueError`` on ANY
    damage — the coordinator's recompute path owns recovery."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ValueError(f"partition {path} unreadable: {e}")
    got = hashlib.sha256(data).hexdigest()
    if got != expect_sha:
        raise ValueError(
            f"partition {path} sha mismatch (got {got[:12]}, want "
            f"{expect_sha[:12]})"
        )
    from locust_tpu_torch.io import serde

    rows, values = serde.read_kvbin(path, key_width)
    return [
        (rows[i].tobytes().rstrip(b"\x00"), int(values[i]))
        for i in range(len(values))
    ]


def merge_pairs(acc: dict, pairs) -> dict:
    """The reduce stage's combine: sum counts per encoded key (the
    engine's "sum" fold over disjoint splits of the same corpus)."""
    for key, value in pairs:
        acc[key] = acc.get(key, 0) + int(value)
    return acc


def chaos_partition(path: str, split: int, part: int) -> None:
    """The shuffle-partition chaos window (docs/FAULTS.md): fires
    between the map and reduce waves on every published partition.
    "drop" models the spill vanishing mid-plan (GC race, disk loss),
    "corrupt" a torn/flipped file — both must surface as a recompute,
    never a wrong answer."""
    rule = faultplan.fire("plan.partition", path=path, split=split,
                          part=part)
    if rule is None:
        return
    if rule.action == "drop":
        try:
            os.unlink(path)
        except OSError:
            pass
    elif rule.action == "corrupt":
        try:
            with open(path, "rb") as f:
                data = f.read()
            mangled = faultplan.active().mutate(rule, data)
            with open(path, "wb") as f:
                f.write(mangled)
        except OSError:
            pass


# ------------------------------------------------------------- finalize


def finalize(
    shape: StageShape, cfg, n_lines: int, partition_pairs: list[list],
    truncated: bool, overflow: int, device=None,
) -> tuple[bytes, int, bool, int]:
    """Fold the reduced shuffle partitions into the solo path's exact
    result: (rendered output bytes, distinct, truncated, overflow).

    Wordcount partitions re-merge through the engine's own
    sort+segment-reduce (``batching.merge_shard_results``, the sharded
    wordcount path's proven-identical merge) so pair ORDER matches the
    solo fold; the composite folds decode into the same host tables the
    solo evaluator builds and render through ``compile.iter_rendered``
    — the one spelling of every sink format.  Device work on ``device``
    (None = CUDA): the caller holds the engine lock.
    """
    from locust_tpu_torch.serve import batch as batching

    from .compile import _render

    if shape.fold == "wordcount":
        shard_results = [
            {"pairs": pairs, "truncated": False, "overflow_tokens": 0}
            for pairs in partition_pairs
        ]
        shard_results.append({
            "pairs": [], "truncated": bool(truncated),
            "overflow_tokens": int(overflow),
        })
        pairs, distinct, trunc, ovf = batching.merge_shard_results(
            shard_results, cfg, "sum", device=device
        )
        return _render("table", pairs), distinct, trunc, ovf
    table: dict = {}
    for pairs in partition_pairs:
        for raw, count in pairs:
            key = decode_key(shape.fold, raw)
            table[key] = table.get(key, 0) + int(count)
    if shape.fold == "tf":
        from locust_tpu_torch.apps.tfidf import scores_from_tf

        # n_docs exactly as the solo evaluator derives it: distinct
        # GLOBAL doc ids over the input (arange(n) // lines_per_doc).
        n_docs = -(-int(n_lines) // shape.lines_per_doc) or 1
        scores = scores_from_tf(table, n_docs)
        return _render("tfidf", scores), len(scores), False, 0
    # index: postings = {word: sorted unique doc ids} (the counts only
    # carried the shuffle; the inverted index keeps membership).
    postings: dict = {}
    for word, doc in table:
        postings.setdefault(word, set()).add(int(doc))
    postings = {w: sorted(d) for w, d in postings.items()}
    return _render("postings", postings), len(postings), False, 0


# ------------------------------------------------------------ join trees

# The one spelling of the inner-join combine ops — MUST mirror
# compile._eval_join exactly: host Python ints, so a "mul" join's
# products never wrap int32 the way a device merge would.
JOIN_OPS = {
    "sum": lambda a, b: a + b,
    "mul": lambda a, b: a * b,
    "min": min,
}


def tree_doc(tree) -> list:
    """Serialize a JoinTree for the stage RPC wire: nested JSON lists
    ``["join", combine, left, right]`` with ``["leaf"]`` terminals.
    Every leaf of a covered join tree is the SAME corpus wordcount
    table (the join signature only admits wordcount folds over the one
    corpus), so the wire form needs no per-leaf identity."""
    if isinstance(tree, FoldLeaf):
        return ["leaf"]
    return ["join", tree.combine, tree_doc(tree.left), tree_doc(tree.right)]


def eval_tree_doc(doc: list, table: dict) -> dict:
    """Evaluate a serialized join tree over one co-partitioned bin's
    wordcount table: inner-join semantics exactly as the solo
    ``compile._eval_join`` (key in both sides, ``op(left, right)``).
    Restricting to one hash bin is exact because ``partition_of``
    routes every key of every leaf to the same bin."""
    if doc[0] == "leaf":
        return table
    _, combine, left_doc, right_doc = doc
    left = eval_tree_doc(left_doc, table)
    right = eval_tree_doc(right_doc, table)
    op = JOIN_OPS[combine]
    return {k: op(v, right[k]) for k, v in left.items() if k in right}


def finalize_join(bin_pairs: list[list]) -> tuple[bytes, int, bool, int]:
    """Merge the join wave's per-bin results into the solo bytes: the
    bins are key-disjoint, so one host sort of the concatenation IS the
    solo evaluator's ``sorted(...)`` over the whole join.  Host-side on
    purpose — join values are unbounded Python ints (mul combines), so
    a device sort_and_compact merge would wrap; disjointness makes the
    compaction a no-op anyway.  Accounting mirrors solo ``_eval_join``:
    (distinct, False, 0)."""
    from .compile import _render

    pairs = sorted(p for chunk in bin_pairs for p in chunk)
    return _render("table", pairs), len(pairs), False, 0


# ----------------------------------------------------------- rank shards

# Rank-shuffle key lane: node ids as zero-padded decimal, one width for
# every epoch partition (ties the LKVB row width down without a cfg).
RANK_KEY_WIDTH = 10


def shard_ranges(num_nodes: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous per-worker rank shards [lo, hi): the same balanced
    split on every host/attempt so recomputes and WAL resumes agree."""
    return [
        (i * num_nodes // n_shards, (i + 1) * num_nodes // n_shards)
        for i in range(n_shards)
    ]


def encode_rank_pairs(lo: int, ranks) -> list:
    """One epoch shard's ranks as LKVB pairs: key = zero-padded node
    id, value = the float32 BIT PATTERN as int32 (the kvbin value lane
    is int32; a bit-cast round-trips exactly, a decimal rendering would
    not)."""
    bits = np.ascontiguousarray(np.asarray(ranks, np.float32)).view(
        np.int32
    )
    return [(b"%010d" % (lo + i), int(bits[i])) for i in range(len(bits))]


def decode_rank_values(pairs: list):
    """Invert encode_rank_pairs for one partition read in row order."""
    return np.array(
        [v for _, v in pairs], dtype=np.int32
    ).view(np.float32)


def finalize_ranks(rank_slices: list) -> tuple[bytes, int, bool, int]:
    """Concatenate the final epoch's shard slices (shard order == node
    order) into the solo render: ``_render("ranks", ...)`` is the one
    spelling, accounting mirrors solo ``_eval_pagerank`` (n, False, 0)."""
    from .compile import _render

    ranks = np.concatenate(
        [np.asarray(s, np.float32) for s in rank_slices]
    )
    return _render("ranks", ranks), len(ranks), False, 0
