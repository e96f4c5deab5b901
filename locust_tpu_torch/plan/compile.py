"""Lower a validated logical plan onto the engine and the apps.

Port of the single-device lowerings of ``locust_tpu/plan/compile.py``.
Compilation pattern-matches subgraphs of the DAG onto the primitives the
port already trusts —

  * ``map(tokenize_count) → shuffle(by_key) → reduce(sum)`` over a text
    source fuses into the engine's one-fold-per-block WordCount
    (``MapReduceEngine``), exactly the CLI's pipeline — so a
    plan-compiled run IS the hand-wired run, byte for byte, and
    checkpoints land at the fold-stage boundary
    (``run_checkpointed``/``run_stream``);
  * ``map(tokenize_pairs) → shuffle → reduce(sum)`` fuses into the
    composite-key tf fold (``apps.tfidf.term_doc_counts``);
  * ``map(tokenize_pairs) → shuffle → reduce(collect_docs)`` fuses into
    the inverted-index fold (``apps.inverted_index``);
  * ``map(tfidf_score)`` over a tf table is the host-side rescore fold;
  * ``iterate(pagerank)`` over an edge source lowers onto
    ``apps.pagerank``;
  * ``join(inner)`` merges two terminal tables on key — a host fold over
    device-built tables;
  * ``sink`` renders the terminal value to the EXACT bytes the CLI
    commands print.

A composition outside these signatures is a loud ``PlanError`` at
compile time, never a silently-wrong execution.  Under ``mesh=True`` the
folds lower onto the mesh tier (``locust_tpu_torch.parallel``, one rank
per process, the world this process joined or a world of one): WordCount
onto ``DistributedMapReduce``, the index onto
``build_inverted_index_mesh`` and PageRank onto ``ShardedPageRank``; the
tf fold has no mesh lowering.  A compiled plan runs on CUDA unless
``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from locust_tpu_torch import obs
from locust_tpu_torch.plan.nodes import Node, Plan, PlanError
from locust_tpu_torch.plan.optimize import (
    incremental_delta,
    optimize as optimize_plan,
    record_rewrite,
)

# Bound on the pagerank state size of ``run_corpus``: ``num_nodes``
# derives from the max node id in the CORPUS, so a 12-byte corpus naming
# node 2e9 would otherwise allocate multi-GB dense rank/degree vectors.
# 2^24 nodes ≈ 67 MB per dense float32 vector.  ``run()`` stays
# unbounded: its caller chose the graph.
SERVE_MAX_PAGERANK_NODES = 1 << 24

# Lowered stage shapes (the compiler's internal vocabulary; every
# NODE_KINDS entry is matched somewhere below).
_FOLDS = {
    ("tokenize_count", "sum"): "wordcount",
    ("tokenize_pairs", "sum"): "tf",
    ("tokenize_pairs", "collect_docs"): "index",
}


@dataclasses.dataclass
class PlanResult:
    """One executed plan: the workload-shaped ``value`` (pairs list /
    dict / ranks array), the sink-rendered ``output`` bytes (``None``
    when ``render=False``), and the loss/limit accounting."""

    value: object
    output: bytes | None
    distinct: int
    truncated: bool
    overflow_tokens: int
    run_result: object | None = None  # engine RunResult (wordcount fold)


class CompiledPlan:
    """A plan lowered to an executable stage tree.

    Holds the underlying engine lazily and reuses it across ``run``
    calls, as a resident ``MapReduceEngine`` would be reused.
    """

    def __init__(self, plan: Plan, cfg=None, mesh: bool = False,
                 optimize: bool = True, device=None):
        from locust_tpu_torch.engine import resolve_device

        self.plan = plan  # the ORIGINAL plan: cache identity
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self._engine = None  # lazy MapReduceEngine (wordcount fold)
        # The rewrite pass (plan/optimize.py) runs between validation
        # and lowering; ``self.plan`` stays the original so every
        # fingerprint-keyed identity is untouched, and the LOWERED plan
        # is the optimizer's output — byte-identical by the rule
        # contracts.
        self.optimized = (
            optimize_plan(plan, cfg=cfg, mesh=mesh) if optimize else None
        )
        self._lowered = (
            self.optimized.plan if self.optimized is not None else plan
        )
        with obs.span("plan.compile", plan=plan.fingerprint()):
            self._by_id = self._lowered.by_id()
            self._sink = self._lowered.sink()
            self._stages: dict[str, tuple] = {}
            self._root = self._lower(self._sink.id)
        if cfg is None and any(
            n.kind == "source" and n.op == "text" for n in plan.nodes
        ):
            raise PlanError(
                "a plan with a text source needs an EngineConfig"
            )
        if mesh and self._needs_mesh_guard():
            raise PlanError(
                "the tf fold has no mesh lowering (the pair table is "
                "device-bounded; use the index plan for the distributed "
                "path)"
            )

    def _needs_mesh_guard(self) -> bool:
        return any(
            s[0] == "fold" and s[1] == "tf" for s in self._stages.values()
        )

    # ------------------------------------------------------------ lowering

    def _lower(self, nid: str) -> str:
        """Classify node ``nid`` (and its producers) into a stage;
        returns the stage id (== node id).  Memoized so a multi-consumer
        node lowers (and later executes) once."""
        if nid in self._stages:
            return nid
        n = self._by_id[nid]
        if n.kind == "source":
            stage = ("source", n)
        elif n.kind == "reduce":
            shuf = self._by_id[n.inputs[0]]
            if shuf.kind != "shuffle":
                raise PlanError(
                    f"node {n.id!r}: reduce must consume a shuffle node "
                    "(the engine fuses group+combine into one sort)"
                )
            mapper = self._by_id[shuf.inputs[0]]
            if mapper.kind != "map":
                raise PlanError(
                    f"node {shuf.id!r}: shuffle must consume a map node"
                )
            fold = _FOLDS.get((mapper.op, n.op))
            if fold is None:
                raise PlanError(
                    f"node {n.id!r}: no fold lowering for map "
                    f"{mapper.op!r} + reduce {n.op!r}"
                )
            src_id = self._lower(mapper.inputs[0])
            stage = ("fold", fold, src_id)
        elif n.kind == "map" and n.op == "tfidf_score":
            tf_id = self._lower(n.inputs[0])
            tf_stage = self._stages[tf_id]
            if not (tf_stage[0] == "fold" and tf_stage[1] == "tf"):
                raise PlanError(
                    f"node {n.id!r}: tfidf_score must consume the tf fold"
                )
            composed = (
                self.optimized is not None
                and n.id in self.optimized.composed_scores
            )
            stage = ("score", tf_id, composed)
        elif n.kind == "map":
            # tokenize maps only exist fused under a shuffle+reduce; a
            # bare token stream has no materialization (the fixed-slot
            # emit tensor is an engine-internal shape).
            raise PlanError(
                f"node {n.id!r}: map {n.op!r} must feed a "
                "shuffle -> reduce chain"
            )
        elif n.kind == "shuffle":
            raise PlanError(
                f"node {n.id!r}: shuffle must feed a reduce node (the "
                "engine's one-sort fold groups and combines together)"
            )
        elif n.kind == "join":
            left = self._lower(n.inputs[0])
            right = self._lower(n.inputs[1])
            stage = ("join", left, right, n.param("combine", "sum"))
        elif n.kind == "iterate":
            src_id = self._lower(n.inputs[0])
            src = self._by_id[src_id]
            if not (src.kind == "source" and src.op == "edges"):
                raise PlanError(
                    f"node {n.id!r}: iterate(pagerank) must consume an "
                    "edges source"
                )
            stage = ("pagerank", src_id,
                     n.param("num_iters", 20), n.param("damping", 0.85))
        elif n.kind == "sink":
            stage = ("render", n.op, self._lower(n.inputs[0]))
        else:  # pragma: no cover - Plan validation owns kind closure
            raise PlanError(f"node {n.id!r}: unknown kind {n.kind!r}")
        self._stages[nid] = stage
        return nid

    # ----------------------------------------------------------- execution

    def run(
        self,
        data=None,
        *,
        num_nodes: int | None = None,
        max_nodes: int | None = None,
        timed: bool = False,
        render: bool = True,
        finalize: bool = True,
        checkpoint_dir: str | None = None,
        every: int = 8,
        sub_cache=None,
        corpus_sha: str | None = None,
        corpus_bytes: bytes | None = None,
    ) -> PlanResult:
        """Execute the compiled plan.

        ``data`` feeds the source node(s): a rows array / list of line
        bytes for a text source, an ``(src, dst)`` edge-array pair for
        an edges source (numpy arrays, or tensors, which stay on their
        device), or a ``{input_name: data}`` dict when sources
        name distinct inputs (``source`` param ``input``; default
        ``"corpus"``).  ``timed`` routes the wordcount fold through
        ``timed_run`` (the reference's stage report); ``checkpoint_dir``
        places crash-resumable snapshots at the fold-stage boundary
        (``run_checkpointed``).  ``render=False`` skips the sink's
        output-bytes rendering (the CLI commands print from ``value``);
        ``finalize=False`` additionally skips the wordcount fold's
        host-pairs decode (``value`` comes back None, ``run_result``
        carries the device table) — for the CLI's staged map node, which
        only dumps the raw table.  Only a plan whose sink consumes the
        wordcount fold directly may skip it.

        ``sub_cache`` (with ``corpus_sha`` and ``corpus_bytes``, as
        ``run_corpus`` passes them) is a sub-plan result cache: any
        object with the JAX package's ``serve.cache.SubPlanCache``
        methods ``get``, ``put``, ``prefix_candidates`` and
        ``record_incremental``.
        """
        stage = self._stages[self._stages[self._root][2]]
        if not finalize and not (
            stage[0] == "fold" and stage[1] == "wordcount"
        ):
            raise PlanError(
                "finalize=False is only meaningful for a sink fed by "
                "the wordcount fold (other stages need the decoded value)"
            )
        if not finalize and render:
            # There is no decoded value to render — a None would reach
            # _render as a raw TypeError instead of a loud PlanError.
            raise PlanError("finalize=False requires render=False")
        with obs.span("plan.run", plan=self.plan.fingerprint()):
            ctx = _RunCtx(self, data, num_nodes, timed,
                          checkpoint_dir, every, finalize=finalize,
                          max_nodes=max_nodes, sub_cache=sub_cache,
                          corpus_sha=corpus_sha,
                          corpus_bytes=corpus_bytes)
            value = ctx.eval(self._stages[self._root][2])
            render_op = self._stages[self._root][1]
            output = _render(render_op, value) if render else None
            distinct, truncated, overflow = ctx.accounting(
                self._stages[self._root][2], value
            )
            return PlanResult(
                value=value, output=output, distinct=distinct,
                truncated=truncated, overflow_tokens=overflow,
                run_result=ctx.run_result,
            )

    def run_stream(self, blocks, **kw):
        """Bounded-memory passthrough for a pure wordcount-fold plan:
        delegates to ``MapReduceEngine.run_stream`` (same checkpoint/
        resume contract) and returns the raw ``RunResult``."""
        stage = self._stages[self._stages[self._root][2]]
        if not (stage[0] == "fold" and stage[1] == "wordcount"
                and not self.mesh):
            raise PlanError(
                "run_stream supports the single-device wordcount fold "
                "plan only"
            )
        return self._wordcount_engine().run_stream(blocks, **kw)

    def run_corpus(self, corpus: bytes, *, sub_cache=None,
                   corpus_sha: str | None = None) -> PlanResult:
        """Raw corpus bytes in, rendered result out (the JAX serve tier's
        entry).  Text sources split lines with ``bytes.splitlines``; edge
        sources parse the SNAP ``src dst`` format exactly like the CLI
        (``cli_apps.load_edges``).  ONE corpus only: a plan whose sources
        name distinct ``input``s would silently self-join the same bytes
        — loud instead."""
        named = sorted({
            n.param("input", "corpus")
            for n in self.plan.nodes if n.kind == "source"
        } - {"corpus"})
        if named:
            raise PlanError(
                f"run_corpus feeds ONE corpus; this plan's sources name "
                f"distinct inputs {named} — submit it through run() "
                "with a data dict instead"
            )
        if any(n.kind == "source" and n.op == "edges"
               for n in self.plan.nodes):
            src, dst = edges_from_bytes(corpus)
            return self.run(
                (src, dst), max_nodes=SERVE_MAX_PAGERANK_NODES
            )
        if sub_cache is not None and corpus_sha is None:
            corpus_sha = hashlib.sha256(corpus).hexdigest()
        return self.run(corpus.splitlines(), sub_cache=sub_cache,
                        corpus_sha=corpus_sha, corpus_bytes=corpus)

    def _wordcount_engine(self):
        if self._engine is None:
            from locust_tpu_torch.engine import MapReduceEngine

            cfg = self.cfg
            if self.optimized is not None and self.optimized.fuse_kernel:
                # fuse_fold_kernel (plan/optimize.py): the wordcount
                # fold engages the fused kernel — the engine's own
                # eligibility check stays the runtime authority and
                # degrades to plain hasht byte-identically off supported
                # shapes.
                cfg = dataclasses.replace(cfg, sort_mode="fused")
            self._engine = MapReduceEngine(cfg, device=self.device)
        return self._engine


def compile_plan(plan: Plan, cfg=None, mesh: bool = False,
                 optimize: bool = True, device=None) -> CompiledPlan:
    """Lower ``plan`` onto the engine tier; raises ``PlanError`` on any
    composition outside the supported signatures.  ``optimize=False``
    skips the rewrite
    pass (plan/optimize.py) — the naive 1:1 lowering the optimizer's
    byte-identity contract is pinned against.  ``device=None`` is
    CUDA."""
    return CompiledPlan(plan, cfg=cfg, mesh=mesh, optimize=optimize,
                        device=device)


class _RunCtx:
    """One plan execution: stage memo + source staging + accounting."""

    def __init__(self, cp: CompiledPlan, data, num_nodes, timed,
                 checkpoint_dir, every, finalize: bool = True,
                 max_nodes: int | None = None, sub_cache=None,
                 corpus_sha: str | None = None,
                 corpus_bytes: bytes | None = None):
        self.cp = cp
        self.data = data
        self.num_nodes = num_nodes
        self.max_nodes = max_nodes
        self.timed = timed
        self.checkpoint_dir = checkpoint_dir
        self.every = every
        self.finalize = finalize
        self.run_result = None
        self.sub_cache = sub_cache
        self.corpus_sha = corpus_sha
        self.corpus_bytes = corpus_bytes
        self._memo: dict[str, object] = {}
        self._acct: dict[str, tuple] = {}  # stage id -> (dist, trunc, ovf)

    def _sub_engaged(self) -> bool:
        """Per-edge sub-result caching engages only on the cached corpus
        path (run_corpus with a cache): plain host pairs in/out, no
        engine side effects — timed/checkpointed/unfinalized runs need
        the engine's own artifacts, so they stay naive."""
        return (
            self.sub_cache is not None
            and self.corpus_sha is not None
            and self.corpus_bytes is not None
            and self.finalize
            and not self.timed
            and not self.checkpoint_dir
            and not self.cp.mesh
        )

    # -------------------------------------------------------------- eval

    def eval(self, sid: str):
        if sid in self._memo:
            return self._memo[sid]
        stage = self.cp._stages[sid]
        kind = stage[0]
        if kind == "source":
            out = self._eval_source(stage[1])
        elif kind == "fold":
            out = self._eval_fold(sid, stage)
        elif kind == "score":
            out = self._eval_score(stage)
        elif kind == "join":
            out = self._eval_join(sid, stage)
        elif kind == "pagerank":
            out = self._eval_pagerank(sid, stage)
        else:  # pragma: no cover - render handled by run()
            raise PlanError(f"unexpected stage {kind!r}")
        self._memo[sid] = out
        return out

    def _source_data(self, n: Node):
        name = n.param("input", "corpus")
        data = self.data
        if isinstance(data, dict):
            if name not in data:
                raise PlanError(
                    f"source {n.id!r}: no input named {name!r} in the "
                    f"run data (have: {sorted(data)})"
                )
            data = data[name]
        if data is None:
            raise PlanError(f"source {n.id!r}: run() got no input data")
        return data

    def _eval_source(self, n: Node):
        data = self._source_data(n)
        if n.op == "edges":
            from locust_tpu_torch.apps.pagerank import edge_column

            src, dst = data
            return edge_column(src), edge_column(dst)
        from locust_tpu_torch.core import bytes_ops

        cfg = self.cp.cfg
        rows = (
            data
            if isinstance(data, np.ndarray)
            else bytes_ops.strings_to_rows(list(data), cfg.line_width)
        )
        k = n.param("lines_per_doc", 1)
        ids = (np.arange(rows.shape[0]) // k).astype(np.int32)
        return rows, ids

    def _eval_fold(self, sid: str, stage):
        """Fold-stage dispatch: sub-plan cache consult (exact hit ->
        skip even the source staging; verified append-only regrowth ->
        delta-only refold + merge) before the full fold.  Every path
        returns EXACTLY what the naive fold returns — cached values are
        the bytes a previous identical fold produced, and the
        incremental merge rides the mergeable-table property with
        bail-to-full guards wherever a full refold could differ
        (truncation, capacity)."""
        if not self._sub_engaged():
            return self._eval_fold_full(sid, stage)
        sub = self.sub_cache
        key_fp = self.cp._lowered.node_fingerprint(sid)
        cfg_fp = self.cp.cfg.fingerprint()
        ent = sub.get(key_fp, cfg_fp, self.corpus_sha)
        if ent is not None:
            obs.metric_inc("plan.subcache_hits")
            return self._restore_fold_entry(sid, stage, ent)
        obs.metric_inc("plan.subcache_misses")
        ent = self._incremental_fold(sid, stage, sub, key_fp, cfg_fp)
        if ent is not None:
            return self._restore_fold_entry(sid, stage, ent)
        value = self._eval_fold_full(sid, stage)
        sub.put(key_fp, cfg_fp, self.corpus_sha,
                self._fold_entry(sid, stage, value))
        return value

    def _restore_fold_entry(self, sid: str, stage, ent: dict):
        fold = stage[1]
        self._acct[sid] = (
            int(ent["distinct"]), bool(ent["truncated"]),
            int(ent["overflow"]),
        )
        if fold == "tf":
            src_node = self.cp._stages[stage[2]][1]
            k = src_node.param("lines_per_doc", 1)
            n_lines = int(ent["n_lines"])
            # n_docs exactly as the full path derives it: distinct of
            # arange(n_lines) // k, i.e. ceil(n_lines / k), floor 1.
            self._memo[f"{sid}.n_docs"] = (
                -(-n_lines // k) if n_lines else 1
            )
        value = ent["value"]
        # Shallow copies out of the cache: entry values are shared
        # across runs and must never be mutated by a consumer.
        return list(value) if isinstance(value, list) else dict(value)

    def _fold_entry(self, sid: str, stage, value) -> dict:
        fold = stage[1]
        rows, _ids = self.eval(stage[2])
        dist, trunc, ovf = self._acct[sid]
        return {
            "fold": fold, "value": value,
            "distinct": int(dist), "truncated": bool(trunc),
            "overflow": int(ovf),
            "corpus_len": len(self.corpus_bytes),
            "corpus_sha": self.corpus_sha,
            "n_lines": int(rows.shape[0]),
            "bytes": _fold_value_bytes(fold, value),
        }

    def _incremental_fold(self, sid: str, stage, sub, key_fp, cfg_fp):
        """incremental_fold (plan/optimize.py): look for a cached entry
        over a hash-verified append-only PREFIX of this corpus, refold
        only the delta lines, merge.  Returns the merged entry (also
        stored under the new corpus sha, so future growth chains), or
        None -> full recompute."""
        fold = stage[1]
        if fold not in ("wordcount", "tf"):
            return None  # index postings: exact-hit reuse only
        for cand in sub.prefix_candidates(key_fp, cfg_fp):
            info = incremental_delta(cand, self.corpus_bytes)
            if info is None:
                continue
            merged = self._merge_delta(sid, stage, fold, cand, info)
            if merged is None:
                continue  # guard bailed: the full path owns this run
            sub.put(key_fp, cfg_fp, self.corpus_sha, merged)
            record_rewrite(info["rule"])
            return merged
        return None

    def _merge_delta(self, sid: str, stage, fold: str, ent: dict,
                     info: dict):
        from locust_tpu_torch.engine import _wrap_i32, merge_host_pairs

        cfg = self.cp.cfg
        rows, ids = self.eval(stage[2])
        n_old = int(info["old_n_lines"])
        n_total = int(rows.shape[0])
        if not 0 <= n_old < n_total:
            return None
        delta_rows = rows[n_old:]
        if fold == "wordcount":
            eng = self.cp._wordcount_engine()
            res = eng.run(delta_rows)
            if res.truncated:
                return None
            pairs = merge_host_pairs(
                ent["value"], res.to_host_pairs(), combine=eng.combine
            )
            if len(pairs) > cfg.resolved_table_size:
                # A full refold would truncate, and only IT knows which
                # keys survive — bail to the naive path.
                return None
            dist = len(pairs)
            ovf = int(ent["overflow"]) + int(res.overflow_tokens)
            value = pairs
        else:  # tf
            from locust_tpu_torch.apps.inverted_index import (
                default_pairs_capacity,
            )
            from locust_tpu_torch.apps.tfidf import term_doc_counts

            try:
                tf_delta = term_doc_counts(delta_rows, ids[n_old:], cfg,
                                           device=self.cp.device)
            except ValueError:
                # The delta fold hit a loss condition (overflow /
                # capacity — term_doc_counts raises rather than
                # truncate).  Bail so the NAIVE path recomputes and
                # raises the canonical error for the full corpus.
                return None
            value = dict(ent["value"])
            for key, v in tf_delta.items():
                value[key] = _wrap_i32(int(value.get(key, 0)) + int(v))
            if len(value) > default_pairs_capacity(cfg):
                return None  # a full refold RAISES; let it
            dist, ovf = len(value), 0
        bl = cfg.block_lines
        self.sub_cache.record_incremental(
            delta_blocks=-(-(n_total - n_old) // bl),
            total_blocks=max(1, -(-n_total // bl)),
        )
        return {
            "fold": fold, "value": value,
            "distinct": int(dist), "truncated": False,
            "overflow": int(ovf),
            "corpus_len": len(self.corpus_bytes),
            "corpus_sha": self.corpus_sha,
            "n_lines": n_total,
            "bytes": _fold_value_bytes(fold, value),
        }

    def _eval_fold_full(self, sid: str, stage):
        fold = stage[1]
        src_node = self.cp._stages[stage[2]][1]
        rows, ids = self.eval(stage[2])
        cfg, dev = self.cp.cfg, self.cp.device
        if fold == "wordcount" and self.cp.mesh:
            from locust_tpu_torch.parallel.mesh import make_mesh
            from locust_tpu_torch.parallel.shuffle import DistributedMapReduce

            opt = self.cp.optimized
            if opt is not None and opt.fuse_kernel:
                # fuse_fold_kernel fires for mesh jobs too: the mesh
                # engine's own gate decides at construction (a CPU rank
                # demotes explicitly, fused_demoted, and folds as hasht).
                cfg = dataclasses.replace(cfg, sort_mode="fused")
            res = DistributedMapReduce(make_mesh(device=dev), cfg).run(rows)
            pairs = res.to_host_pairs() if self.finalize else None
            self._acct[sid] = (res.distinct, res.truncated, res.emit_overflow)
            return pairs
        if fold == "wordcount":
            eng = self.cp._wordcount_engine()
            if self.checkpoint_dir:
                res = eng.run_checkpointed(
                    rows, self.checkpoint_dir, every=self.every
                )
            elif self.timed:
                res = eng.timed_run(rows)
            else:
                res = eng.run_fused(rows)
            self.run_result = res
            pairs = res.to_host_pairs() if self.finalize else None
            self._acct[sid] = (
                res.num_segments, res.truncated, res.overflow_tokens
            )
            return pairs
        if fold == "tf":
            from locust_tpu_torch.apps.tfidf import term_doc_counts

            tf = term_doc_counts(rows, ids, cfg, device=dev)
            self._acct[sid] = (len(tf), False, 0)
            # The score stage needs n_docs exactly as build_tfidf
            # derives it: distinct ids over the INPUT, not the table
            # (a doc whose lines carry no tokens still counts).
            self._memo[f"{sid}.n_docs"] = (
                len(set(int(d) for d in ids)) or 1
            )
            return tf
        if fold == "index" and self.cp.mesh:
            from locust_tpu_torch.apps.inverted_index import (
                build_inverted_index_mesh,
            )
            from locust_tpu_torch.parallel.mesh import make_mesh

            index = build_inverted_index_mesh(rows, ids, make_mesh(device=dev), cfg)
            self._acct[sid] = (len(index), False, 0)
            return index
        if fold == "index":
            from locust_tpu_torch.apps.inverted_index import (
                build_inverted_index,
            )

            index = build_inverted_index(rows, ids, cfg, device=dev)
            self._acct[sid] = (len(index), False, 0)
            return index
        raise PlanError(  # pragma: no cover - _FOLDS is closed
            f"unknown fold {fold!r} (source {src_node.id!r})"
        )

    def _eval_score(self, stage):
        from locust_tpu_torch.apps.tfidf import scores_from_tf

        tf_id = stage[1]
        composed = len(stage) > 2 and stage[2]
        if composed and tf_id not in self._memo:
            # compose_score (plan/optimize.py): fold + rescore as ONE
            # stage — the tf table is consumed inline and never
            # retained in the stage memo (the reduce has exactly one
            # consumer, so nothing else can ask for it).
            tf = self._eval_fold(tf_id, self.cp._stages[tf_id])
        else:
            tf = self.eval(tf_id)
        return scores_from_tf(tf, self._memo[f"{tf_id}.n_docs"])

    def _eval_join(self, sid: str, stage):
        _, left_id, right_id, combine = stage
        left = dict(self.eval(left_id))
        right = dict(self.eval(right_id))
        op = {
            "sum": lambda a, b: a + b,
            "mul": lambda a, b: a * b,
            "min": min,
        }[combine]
        pairs = sorted(
            (k, op(v, right[k])) for k, v in left.items() if k in right
        )
        self._acct[sid] = (len(pairs), False, 0)
        return pairs

    def _eval_pagerank(self, sid: str, stage):
        from locust_tpu_torch.apps.pagerank import ShardedPageRank, pagerank

        _, src_id, num_iters, damping = stage
        src, dst = self.eval(src_id)
        n = (
            self.num_nodes
            if self.num_nodes is not None
            else int(max(int(src.max()), int(dst.max()))) + 1
        )
        if self.max_nodes is not None and n > self.max_nodes:
            # The node count derives from corpus CONTENT, so a tiny
            # corpus naming a huge id must reject, not allocate.
            raise PlanError(
                f"pagerank needs {n} dense node slots, past this "
                f"endpoint's cap ({self.max_nodes}); renumber the "
                "graph or run it through the CLI"
            )
        if self.cp.mesh:
            from locust_tpu_torch.parallel.mesh import make_mesh

            ranks = ShardedPageRank(make_mesh(device=self.cp.device), n,
                                    damping=damping).run(src, dst, num_iters=num_iters)
        else:
            ranks = pagerank(
                src, dst, num_nodes=n, num_iters=num_iters, damping=damping,
                device=self.cp.device,
            ).cpu().numpy()
        self._acct[sid] = (n, False, 0)
        return ranks

    def accounting(self, sid: str, value) -> tuple:
        got = self._acct.get(sid)
        if got is not None:
            return got
        try:
            return len(value), False, 0
        except TypeError:
            return 0, False, 0


def _fold_value_bytes(fold: str, value) -> int:
    """Byte-size estimate of one cached fold value (a sub-plan cache's
    LRU accounting: an estimate that tracks growth, not an exact RSS)."""
    if fold == "wordcount":
        return sum(len(k) + 8 for k, _v in value)
    if fold == "tf":
        return sum(len(w) + 16 for (w, _d) in value)
    return sum(len(w) + 8 * len(docs) for w, docs in value.items())


def rank_row(node: int, rank: float) -> bytes:
    """ONE spelling of a pagerank output row — the ``ranks`` sink and
    ``pagerank --top`` (which reorders rows) both use it, so
    the formats cannot drift apart."""
    return f"{node}\t{rank:.8f}\n".encode()


def iter_rendered(op: str, value):
    """Per-row sink rendering, the ONE spelling of each workload's
    output format: ``_render`` joins it for plan results, and the CLI
    commands (``cli_apps``) iterate it directly (honoring ``--limit``) —
    byte-identity holds by construction, not by parallel maintenance."""
    if op == "table":
        for k, v in value:  # pairs are already host-finalized + sorted
            yield k + b"\t" + str(v).encode() + b"\n"
    elif op == "tfidf":
        for word, doc in sorted(value):
            yield (
                word + b"\t" + str(doc).encode()
                + b"\t" + f"{value[(word, doc)]:.6f}".encode() + b"\n"
            )
    elif op == "postings":
        for word in sorted(value):
            docs = b",".join(str(d).encode() for d in value[word])
            yield word + b"\t" + docs + b"\n"
    elif op == "ranks":
        for i in range(value.shape[0]):
            yield rank_row(i, value[i])
    else:  # pragma: no cover - NODE_OPS closes the sink set
        raise PlanError(f"unknown sink op {op!r}")


def _render(op: str, value) -> bytes:
    """Sink rendering: byte-for-byte the CLI commands' stdout."""
    return b"".join(iter_rendered(op, value))


def edges_from_bytes(corpus: bytes):
    """SNAP-style ``src dst`` edge list from raw bytes.  The ONE parser
    (comment/2-field/int/negative-id rules): ``cli_apps.load_edges``
    delegates here."""
    src, dst = [], []
    for ln_no, ln in enumerate(corpus.splitlines(), 1):
        ln = ln.strip()
        if not ln or ln.startswith(b"#"):
            continue
        parts = ln.split()
        if len(parts) != 2:
            raise PlanError(
                f"edge list line {ln_no}: expected 'src dst', got "
                f"{ln[:60]!r}"
            )
        try:
            src.append(int(parts[0]))
            dst.append(int(parts[1]))
        except ValueError:
            raise PlanError(
                f"edge list line {ln_no}: non-integer node id {ln[:60]!r}"
            )
    if not src:
        raise PlanError("edge list has no edges")
    s = np.asarray(src, np.int64)
    d = np.asarray(dst, np.int64)
    if s.min() < 0 or d.min() < 0:
        raise PlanError("edge list has a negative node id")
    return s, d
