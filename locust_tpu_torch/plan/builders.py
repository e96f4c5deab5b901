"""Canonical plans for the workload ladder.

Port of ``locust_tpu/plan/builders.py``: the ONE spelling of each
workload as a logical DAG — the CLI commands (``cli.py``, ``cli_apps.py``)
construct these instead of wiring stage chains by hand, so "the
wordcount pipeline" has exactly one definition, whose ``fingerprint()``
equals the JAX package's.
"""

from __future__ import annotations

from locust_tpu_torch.plan.nodes import Plan, node


def wordcount_plan() -> Plan:
    """source → tokenize → group → sum → table: the reference pipeline
    (main.cu:397-473) as a plan.  Compiles onto the engine's fused
    one-sort-per-block fold (plan/compile.py)."""
    return Plan((
        node("corpus", "source", "text"),
        node("tokenize", "map", "tokenize_count", ("corpus",)),
        node("group", "shuffle", "by_key", ("tokenize",)),
        node("counts", "reduce", "sum", ("group",)),
        node("out", "sink", "table", ("counts",)),
    ))


def tfidf_plan(lines_per_doc: int = 1) -> Plan:
    """The two-stage tf-idf pipeline: a (word, doc)-keyed count fold,
    then a table-level rescore — tf from the device, df/n_docs as host
    folds over the (tiny) pair table (apps/tfidf.py)."""
    return Plan((
        node("corpus", "source", "text", lines_per_doc=lines_per_doc),
        node("pairs", "map", "tokenize_pairs", ("corpus",)),
        node("group", "shuffle", "by_key", ("pairs",)),
        node("tf", "reduce", "sum", ("group",)),
        node("score", "map", "tfidf_score", ("tf",)),
        node("out", "sink", "tfidf", ("score",)),
    ))


def index_plan(lines_per_doc: int = 1) -> Plan:
    """Inverted index: (word, doc) pairs grouped by word, reduced to the
    distinct sorted posting list (apps/inverted_index.py)."""
    return Plan((
        node("corpus", "source", "text", lines_per_doc=lines_per_doc),
        node("pairs", "map", "tokenize_pairs", ("corpus",)),
        node("group", "shuffle", "by_key", ("pairs",)),
        node("postings", "reduce", "collect_docs", ("group",)),
        node("out", "sink", "postings", ("postings",)),
    ))


def pagerank_plan(num_iters: int = 20, damping: float = 0.85) -> Plan:
    """Iterative PageRank over an edge list: the iterate node wraps the
    damped power iteration the apps tier already lowers to a dense
    segment-sum + psum (apps/pagerank.py)."""
    return Plan((
        node("edges", "source", "edges"),
        node("ranks", "iterate", "pagerank", ("edges",),
             num_iters=num_iters, damping=damping),
        node("out", "sink", "ranks", ("ranks",)),
    ))
