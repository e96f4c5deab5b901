"""PyTorch port, the plan layer (``locust_tpu_torch.plan``) against the JAX
package: canonical JSON and fingerprints of the four builders, a join
plan and random plans; validation and lowering errors; the optimizer's
four rewrite rules, identity-pinned; the sub-plan cache branch and
``incremental_fold`` through ``run_corpus`` with each package's own
``SubPlanCache`` (entries and counters equal); every plan's rendered
bytes, single-device and under ``mesh=True`` (the tf fold refused)."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import dataclasses
import hashlib
import random

import numpy as np
import pytest

from locust_tpu import plan as jplan
from locust_tpu.plan import optimize as joptimize
from locust_tpu.plan.compile import compile_plan as jcompile
from locust_tpu.plan.optimize import incremental_delta as jdelta
from locust_tpu.serve.cache import SubPlanCache as JSubPlanCache
from locust_tpu_torch import plan as tplan
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.core.bytes_ops import strings_to_rows
from locust_tpu_torch.plan import optimize as toptimize
from locust_tpu_torch.plan.compile import compile_plan as _tcompile
from locust_tpu_torch.plan.optimize import incremental_delta, record_rewrite
from locust_tpu_torch.serve.cache import SubPlanCache
from test_plan import CFG as JCFG
from test_plan import LINES, _chain_templates

TCFG = TConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
CORPUS = b"".join(ln + b"\n" for ln in LINES)
EDGES = (np.array([0, 1, 2, 2, 3, 4, 4, 6]), np.array([1, 2, 0, 3, 0, 1, 2, 5]))


def tcompile(p, cfg=None, **kw):
    return _tcompile(p, cfg, device="cpu", **kw)


def _join(pkg, combine="sum"):
    def chain(tag, name):
        return [
            pkg.node(f"{tag}s", "source", "text", input=name),
            pkg.node(f"{tag}m", "map", "tokenize_count", (f"{tag}s",)),
            pkg.node(f"{tag}g", "shuffle", "by_key", (f"{tag}m",)),
            pkg.node(f"{tag}c", "reduce", "sum", (f"{tag}g",)),
        ]
    return pkg.Plan(tuple(chain("l", "left") + chain("r", "right") + [
        pkg.node("j", "join", "inner", ("lc", "rc"), combine=combine),
        pkg.node("out", "sink", "table", ("j",)),
    ]))


def _twins(pkg):
    """Two identical wordcount chains under a join: the CSE target."""
    chains = [[
        pkg.node(f"{t}s", "source", "text"),
        pkg.node(f"{t}m", "map", "tokenize_count", (f"{t}s",)),
        pkg.node(f"{t}g", "shuffle", "by_key", (f"{t}m",)),
        pkg.node(f"{t}r", "reduce", "sum", (f"{t}g",)),
    ] for t in "ab"]
    return pkg.Plan(tuple(chains[0] + chains[1] + [
        pkg.node("j", "join", "inner", ("ar", "br"), combine="sum"),
        pkg.node("o", "sink", "table", ("j",)),
    ]))


PLANS = {
    "wordcount": lambda pkg: pkg.wordcount_plan(),
    "tfidf": lambda pkg: pkg.tfidf_plan(3),
    "index": lambda pkg: pkg.index_plan(2),
    "pagerank": lambda pkg: pkg.pagerank_plan(7, 0.9),
    "join": _join,
    "twins": _twins,
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_identity_equals_jax(name):
    j, t = PLANS[name](jplan), PLANS[name](tplan)
    assert t.canonical_json() == j.canonical_json()
    assert t.fingerprint() == j.fingerprint()
    assert t.topo_order() == j.topo_order() and t.node_types() == j.node_types()
    assert {n.id: t.node_fingerprint(n.id) for n in t.nodes} == \
        {n.id: j.node_fingerprint(n.id) for n in j.nodes}
    assert tplan.from_json(t.canonical_json()) == t


def test_random_plans_identity_and_rewrites_equal_jax():
    rng = random.Random(1234)
    seen = set()
    for _ in range(50):
        j = _chain_templates(rng)
        t = tplan.from_doc(j.to_doc())
        assert t.fingerprint() == j.fingerprint()
        for jcfg, tcfg in ((JCFG, TCFG), (dataclasses.replace(JCFG, sort_mode="hasht"),
                                          dataclasses.replace(TCFG, sort_mode="hasht"))):
            jo, to = joptimize(j, jcfg), toptimize(t, tcfg)
            assert (to.applied, to.fuse_kernel, to.composed_scores) == \
                (jo.applied, jo.fuse_kernel, jo.composed_scores)
            assert to.plan.canonical_json() == jo.plan.canonical_json()
        seen.add(t.fingerprint())
    assert len(seen) > 30


VALIDATION = [
    lambda p: p.Plan((p.node("a", "sorce", "text"),)),
    lambda p: p.Plan((p.node("a", "source", "txet"),)),
    lambda p: p.Plan((p.node("a", "source", "text"), p.node("a", "sink", "table", ("a",)))),
    lambda p: p.Plan((p.node("a", "source", "text"), p.node("b", "map", "tokenize_count", ("a", "a")))),
    lambda p: p.Plan((p.node("a", "source", "text"), p.node("b", "map", "tokenize_count", ("zz",)))),
    lambda p: p.Plan((p.node("b", "map", "tokenize_count", ("b",)),)),
    lambda p: p.Plan((p.node("a", "source", "text"), p.node("out", "sink", "ranks", ("a",)))),
    lambda p: p.Plan((p.node("a", "source", "text"),)),
    lambda p: p.Plan((p.node("a", "source", "text", lines_per_doc=0),
                      p.node("out", "sink", "table", ("a",)))),
    lambda p: p.pagerank_plan(10_001),
    lambda p: p.from_json("not json {"),
    lambda p: p.from_doc({"plan_version": 99, "nodes": []}),
    lambda p: p.from_doc({"plan_version": 1, "nodes": [{"id": "a", "kind": "source", "op": "text",
                                                        "params": {"kind": 1}}]}),
]


@pytest.mark.parametrize("case", range(len(VALIDATION)))
def test_validation_errors_equal_jax(case):
    with pytest.raises(jplan.PlanError) as theirs:
        VALIDATION[case](jplan)
    with pytest.raises(tplan.PlanError) as ours:
        VALIDATION[case](tplan)
    assert str(ours.value) == str(theirs.value)


def _unchecked(pkg, nodes):
    """A Plan that skips validation: the compiler's own guards are what
    stops it."""
    p = object.__new__(pkg.Plan)
    object.__setattr__(p, "nodes", tuple(pkg.node(*n[:3], n[3] if len(n) > 3 else ()) for n in nodes))
    object.__setattr__(p, "version", 1)
    return p


LOWER = [  # each reaches one PlanError of CompiledPlan._lower
    [("s", "source", "text"), ("m", "map", "tokenize_count", ("s",)),
     ("r", "reduce", "sum", ("m",)), ("o", "sink", "table", ("r",))],
    [("s", "source", "text"), ("g", "shuffle", "by_key", ("s",)),
     ("r", "reduce", "sum", ("g",)), ("o", "sink", "table", ("r",))],
    [("s", "source", "text"), ("m", "map", "tokenize_count", ("s",)), ("g", "shuffle", "by_key", ("m",)),
     ("r", "reduce", "collect_docs", ("g",)), ("o", "sink", "postings", ("r",))],
    [("s", "source", "text"), ("m", "map", "tokenize_count", ("s",)), ("g", "shuffle", "by_key", ("m",)),
     ("r", "reduce", "sum", ("g",)), ("t", "map", "tfidf_score", ("r",)), ("o", "sink", "tfidf", ("t",))],
    [("s", "source", "text"), ("m", "map", "tokenize_count", ("s",)), ("o", "sink", "table", ("m",))],
    [("s", "source", "text"), ("m", "map", "tokenize_count", ("s",)), ("g", "shuffle", "by_key", ("m",)),
     ("o", "sink", "table", ("g",))],
    [("s", "source", "text"), ("i", "iterate", "pagerank", ("s",)), ("o", "sink", "ranks", ("i",))],
]


@pytest.mark.parametrize("case", range(len(LOWER)))
def test_lowering_errors_equal_jax(case):
    with pytest.raises(jplan.PlanError) as theirs:
        jcompile(_unchecked(jplan, LOWER[case]), JCFG, optimize=False)
    with pytest.raises(tplan.PlanError) as ours:
        tcompile(_unchecked(tplan, LOWER[case]), TCFG, optimize=False)
    assert str(ours.value) == str(theirs.value)


def test_run_time_plan_errors_equal_jax():
    cases = [
        lambda p, c, cfg: c(p.wordcount_plan()),  # a text source needs a config
        lambda p, c, cfg: c(p.tfidf_plan(2), cfg).run(LINES, render=False, finalize=False),
        lambda p, c, cfg: c(p.wordcount_plan(), cfg).run(LINES, finalize=False),
        lambda p, c, cfg: c(p.wordcount_plan(), cfg).run(None),
        lambda p, c, cfg: c(_join(p), cfg).run({"left": LINES}),
        lambda p, c, cfg: c(p.pagerank_plan()).run_stream(iter(())),
        lambda p, c, cfg: c(_join(p), cfg).run_corpus(CORPUS),
        lambda p, c, cfg: c(p.pagerank_plan(2)).run_corpus(b"0 2000000000\n"),
    ]
    for case in cases:
        with pytest.raises(jplan.PlanError) as theirs:
            case(jplan, jcompile, JCFG)
        with pytest.raises(tplan.PlanError) as ours:
            case(tplan, tcompile, TCFG)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_mesh_lowerings_equal_jax(name, monkeypatch):
    """Each plan under ``mesh=True`` as JAX's on a mesh of the port's
    world's size (one rank, in this process); the tf fold refuses."""
    from locust_tpu.parallel import mesh as jmesh
    from locust_tpu_torch.parallel.mesh import shutdown

    real = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda n_devices=None, **k: real(1, **k))
    cfg = None if name == "pagerank" else TCFG
    jcfg = None if name == "pagerank" else JCFG
    if name == "tfidf":
        with pytest.raises(jplan.PlanError) as theirs:
            jcompile(PLANS[name](jplan), jcfg, mesh=True)
        with pytest.raises(tplan.PlanError) as ours:
            tcompile(PLANS[name](tplan), cfg, mesh=True)
        assert str(ours.value) == str(theirs.value)
        return
    data, kw = EDGES if name == "pagerank" else (
        {"left": LINES, "right": LINES[:10]} if name == "join" else LINES), (
        {"num_nodes": 9} if name == "pagerank" else {})
    want = jcompile(PLANS[name](jplan), jcfg, mesh=True).run(data, **kw)
    try:
        got = tcompile(PLANS[name](tplan), cfg, mesh=True).run(data, **kw)
    finally:
        shutdown()
    assert got.output == want.output and len(got.output) > 20
    assert (got.distinct, got.truncated, got.overflow_tokens) == \
        (want.distinct, want.truncated, want.overflow_tokens)


_jax_runs = {}


def _jax_run(name, data, **kw):
    key = (name, repr(kw))
    if key not in _jax_runs:
        cfg = None if name == "pagerank" else JCFG
        _jax_runs[key] = jcompile(PLANS[name](jplan), cfg).run(data, **kw)
    return _jax_runs[key]


@pytest.mark.parametrize("name,kw", [("wordcount", {}), ("wordcount", {"timed": True}),
                                     ("tfidf", {}), ("index", {}), ("pagerank", {"num_nodes": 9}),
                                     ("join", {}), ("twins", {})])
def test_rendered_bytes_equal_jax(name, kw):
    data = EDGES if name == "pagerank" else (
        {"left": LINES, "right": LINES[:10]} if name == "join" else LINES)
    want = _jax_run(name, data, **kw)
    cfg = None if name == "pagerank" else TCFG
    got = tcompile(PLANS[name](tplan), cfg).run(data, **kw)
    naive = tcompile(PLANS[name](tplan), cfg, optimize=False).run(data, **kw)
    assert got.output == naive.output == want.output and len(got.output) > 20
    assert (got.distinct, got.truncated, got.overflow_tokens) == \
        (want.distinct, want.truncated, want.overflow_tokens)


def test_rewrite_registry_and_identity():
    assert tplan.REWRITE_RULES == jplan.REWRITE_RULES
    with pytest.raises(tplan.PlanError, match="not in REWRITE_RULES"):
        record_rewrite("fuse_fold_kernell")
    p = tplan.wordcount_plan()
    opt = toptimize(p, TCFG)
    assert opt.applied == () and opt.plan is p and not opt.fuse_kernel


def test_fuse_fold_kernel_and_compose_score():
    hasht = dataclasses.replace(TCFG, sort_mode="hasht")
    assert toptimize(tplan.wordcount_plan(), hasht).applied == ("fuse_fold_kernel",)
    assert toptimize(tplan.wordcount_plan(), hasht, mesh=True).fuse_kernel
    assert not toptimize(tplan.tfidf_plan(2), hasht).fuse_kernel
    cp, naive = tcompile(tplan.wordcount_plan(), hasht), tcompile(tplan.wordcount_plan(), hasht,
                                                                  optimize=False)
    assert cp.run(LINES).output == naive.run(LINES).output == _jax_run("wordcount", LINES).output
    assert cp._wordcount_engine().cfg.sort_mode == "fused"
    assert naive._wordcount_engine().cfg.sort_mode == "hasht"
    t = tplan.tfidf_plan(2)
    opt = toptimize(t, TCFG)
    assert opt.applied == ("compose_score",) and opt.composed_scores == {"score"} and opt.plan is t


def test_cse_subplan_collapses_twin_chains():
    p = _twins(tplan)
    opt = toptimize(p, TCFG)
    assert opt.applied == ("cse_subplan",) and len(opt.plan.nodes) == 6
    assert opt.plan.canonical_json() == joptimize(_twins(jplan), JCFG).plan.canonical_json()


def test_finalize_false_timed_and_stream_passthrough(tmp_path):
    pres = tcompile(tplan.wordcount_plan(), TCFG).run(LINES, render=False, finalize=False)
    assert pres.value is None and pres.output is None
    assert pres.distinct == pres.run_result.num_segments
    cp = tcompile(tplan.wordcount_plan(), TCFG)
    rows = strings_to_rows(LINES, TCFG.line_width)
    res = cp.run_stream(rows[i:i + 8] for i in range(0, len(rows), 8))
    ck = cp.run(LINES, checkpoint_dir=str(tmp_path / "ck"), every=1)
    assert (tmp_path / "ck" / "state.npz").exists()
    assert ck.value == res.to_host_pairs() == _jax_run("wordcount", LINES).value


def _cached_runs(compile_fn, pkg, cfg, plan_name, corpora, entries=False):
    """Outputs and cache counters over ``corpora`` through one sub-plan
    cache: the JAX package's for the JAX compiler, the port's own for
    the port's."""
    sub = (JSubPlanCache if pkg is jplan else SubPlanCache)()
    cp = compile_fn(PLANS[plan_name](pkg), cfg)
    outs = [cp.run_corpus(c, sub_cache=sub).output for c in corpora]
    if entries:
        return outs, sub.stats(), {k: _entry_view(e) for k, e in sub._entries.items()}
    return outs, sub.stats()


def _entry_view(ent: dict) -> dict:
    """A cache entry with its fold value as plain Python."""
    return {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in ent.items()}


@pytest.mark.parametrize("plan_name", ["wordcount", "tfidf"])
def test_subplan_cache_and_incremental_fold_equal_jax(plan_name):
    """Cold, exact hit, append-only growth twice, and growth that rewrites
    the last line (the boundary guard bails to a full fold): each
    package's outputs and cache counters, against the other's and a
    cold recompute."""
    nonl = CORPUS[:-1]
    corpora = [CORPUS, CORPUS, CORPUS + b"eta theta\nalpha eta\n",
               CORPUS + b"eta theta\nalpha eta\niota\n", nonl, nonl + b" mu\nnu\n"]
    want, jstats = _cached_runs(jcompile, jplan, JCFG, plan_name, corpora)
    got, tstats = _cached_runs(tcompile, tplan, TCFG, plan_name, corpora)
    assert got == want and tstats == jstats
    assert tstats["hits"] == 1 and tstats["incremental_hits"] == 2
    cold = [tcompile(PLANS[plan_name](tplan), TCFG).run_corpus(c).output for c in corpora]
    assert got == cold


def test_index_plan_reuses_only_exact_hits():
    corpora = [CORPUS, CORPUS, CORPUS + b"eta\n"]
    want, jstats = _cached_runs(jcompile, jplan, JCFG, "index", corpora)
    got, tstats = _cached_runs(tcompile, tplan, TCFG, "index", corpora)
    assert got == want and tstats == jstats and tstats["incremental_hits"] == 0


def test_port_subplan_cache_entries_equal_the_jax_cache():
    """The same cached runs leave the same entries (keys, values,
    corpus accounting, byte estimates) in the port's cache as in the
    JAX package's."""
    corpora = [CORPUS, CORPUS + b"eta theta\n"]
    want = _cached_runs(jcompile, jplan, JCFG, "wordcount", corpora, entries=True)
    got = _cached_runs(tcompile, tplan, TCFG, "wordcount", corpora, entries=True)
    assert got == want and len(got[2]) == 2


def test_incremental_delta_guards_equal_jax():
    sha = hashlib.sha256(CORPUS).hexdigest()
    ent = {"corpus_len": len(CORPUS), "corpus_sha": sha, "truncated": False, "n_lines": len(LINES)}
    mid = {"corpus_len": len(CORPUS) - 1, "corpus_sha": hashlib.sha256(CORPUS[:-1]).hexdigest(),
           "truncated": False, "n_lines": len(LINES)}
    grown = CORPUS + b"eta\n"
    cases = [(ent, grown), (ent, CORPUS), (dict(ent, corpus_len=0), grown),
             (dict(ent, truncated=True), grown), (dict(ent, corpus_sha="0" * 64), grown), (mid, grown)]
    got = [incremental_delta(e, c) for e, c in cases]
    assert got == [jdelta(e, c) for e, c in cases]
    assert got[0] == {"rule": "incremental_fold", "old_len": len(CORPUS), "old_n_lines": len(LINES)}
    assert got[1:] == [None] * 5
