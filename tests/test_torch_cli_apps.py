"""PyTorch port, the CLI subcommands (``python -m locust_tpu_torch
pagerank|index|tfidf``): stdout byte-identical to the JAX CLI's on the
CPU with the same flags (both ``main`` in-process); the WordCount CLI
through the compiled plan; ``--trace-out`` valid under both packages'
schemas; and the exits of refused invocations."""

import json
import os

import numpy as np
import pytest
import torch

from locust_tpu import cli as jcli
from locust_tpu.obs.schema import validate_trace as jvalidate
from locust_tpu_torch import cli as tcli
from locust_tpu_torch.obs.schema import validate_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "sample_corpus.txt")
SMALL = ["--block-lines", "64", "--line-width", "128", "--key-width", "32"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps")
    text = d / "c.txt"
    with open(CORPUS, "rb") as f:
        text.write_bytes(b"".join(f.read().splitlines(keepends=True)[:300]))
    rng = np.random.default_rng(11)
    n, e = 1500, 7000
    src = rng.integers(0, n, e)
    src[src % 5 == 0] = 7  # dangling nodes
    dst = rng.zipf(1.4, e) % n
    edges = d / "e.txt"
    edges.write_text("# seeded\n" + "".join(f"{a} {b}\n" for a, b in zip(src, dst)))
    return {"text": str(text), "edges": str(edges), "dir": d}


_jax_out = {}


def _run(capfdbinary, main, argv):
    rc = main(argv)
    return rc, capfdbinary.readouterr()


def _both(capfdbinary, argv):
    """(JAX stdout, port stdout) of ``argv`` with ``--backend cpu``."""
    key = tuple(argv)
    if key not in _jax_out:
        rc, out = _run(capfdbinary, jcli.main, argv + ["--backend", "cpu"])
        assert rc == 0, out.err
        _jax_out[key] = out.out
    rc, out = _run(capfdbinary, tcli.main, argv + ["--backend", "cpu"])
    assert rc == 0, out.err
    return _jax_out[key], out.out


@pytest.mark.parametrize("args", [
    ["--lines-per-doc", "3", "--sort-mode", "hash"],
    ["--lines-per-doc", "1", "--sort-mode", "bitonic", "--limit", "7"],
    ["--lines-per-doc", "50", "--sort-mode", "hasht"],
])
def test_index_stdout_equals_jax(files, capfdbinary, args):
    want, got = _both(capfdbinary, ["index", files["text"], *SMALL, *args])
    assert got == want and got.count(b"\n") >= 7


@pytest.mark.parametrize("args", [
    ["--lines-per-doc", "5", "--sort-mode", "hash1"],
    ["--lines-per-doc", "2", "--sort-mode", "lex", "--limit", "11"],
    ["--lines-per-doc", "40", "--sort-mode", "hashp2"],
])
def test_tfidf_stdout_equals_jax(files, capfdbinary, args):
    want, got = _both(capfdbinary, ["tfidf", files["text"], *SMALL, *args])
    assert got == want and got.count(b"\n") >= 11


@pytest.mark.parametrize("args", [
    [],
    ["--top", "15", "--damping", "0.7", "--num-iters", "5"],
    ["--num-nodes", "2500", "--num-iters", "3"],
])
def test_pagerank_stdout_equals_jax(files, capfdbinary, args):
    want, got = _both(capfdbinary, ["pagerank", files["edges"], *args])
    assert got == want and got.count(b"\n") in (15, 1500, 2500)


def test_wordcount_cli_runs_through_the_compiled_plan(files, capfdbinary, monkeypatch):
    from locust_tpu_torch.plan import compile as tcompile

    compiled = []
    real = tcompile.compile_plan

    def spy(plan, *a, **kw):
        compiled.append(plan.fingerprint())
        return real(plan, *a, **kw)

    monkeypatch.setattr(tcompile, "compile_plan", spy)
    # The JAX CLI's stdout does not depend on the sort mode: one run.
    want, _ = _both(capfdbinary, [files["text"], *SMALL, "--sort-mode", "hash"])
    for mode in (["--sort-mode", "bitonic"], ["--sort-mode", "hasht", "--no-timing"]):
        rc, out = _run(capfdbinary, tcli.main, [files["text"], *SMALL, *mode, "--backend", "cpu"])
        assert rc == 0 and out.out == want and want.count(b"\n") > 100
    from locust_tpu_torch.plan import wordcount_plan

    assert compiled == [wordcount_plan().fingerprint()] * 3


@pytest.mark.parametrize("argv,spans", [
    (["{text}", *SMALL, "--sort-mode", "hash"],
     {"plan.compile", "plan.run", "cli.run", "engine.stage.map", "engine.stage.merge"}),
    (["{text}", "--stream", *SMALL, "--sort-mode", "hash"],
     {"plan.compile", "stream.block", "stream.stall"}),
    (["tfidf", "{text}", "--lines-per-doc", "4", *SMALL], {"plan.compile", "plan.optimize", "plan.run"}),
])
def test_trace_out_validates_under_both_schemas(files, capfdbinary, argv, spans):
    argv = [a.format(text=files["text"]) for a in argv]
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        trace = str(files["dir"] / f"{name}-{len(argv)}.trace.json")
        rc, out = _run(capfdbinary, main, argv + ["--trace-out", trace, "--backend", "cpu"])
        assert rc == 0 and b"trace written" in out.err
        with open(trace) as f:
            doc = json.load(f)
        validate_trace(doc)
        jvalidate(doc)
        names = {e["name"] for e in doc["traceEvents"]}
        assert spans <= names, (name, spans - names)


@pytest.mark.parametrize("argv", [["index", "{text}", "--mesh"], ["pagerank", "{edges}", "--mesh"]])
def test_mesh_flag_exits_until_the_mesh_tier_lands(files, capfdbinary, argv):
    """The JAX CLI runs these on its device mesh; the port refuses them
    and never runs the single-device path in their place."""
    argv = [a.format(**{k: str(v) for k, v in files.items()}) for a in argv]
    rc, out = _run(capfdbinary, tcli.main, argv + ["--backend", "cpu"])
    assert rc == 2 and b"mesh tier" in out.err and out.out == b""


@pytest.mark.parametrize("argv,rc,msg", [
    (["tfidf", "{text}", "--mesh"], 2, b"no mesh variant"),
    (["index", "{text}", "--lines-per-doc", "0"], 2, b"--lines-per-doc"),
    (["pagerank", "{edges}", "--top", "0"], 2, b"--top"),
    (["pagerank", "{edges}", "--num-nodes", "0"], 2, b"--num-nodes"),
    (["pagerank", "{edges}", "--num-nodes", "10"], 1, b"max node id"),
    (["pagerank", "{text}"], 1, b"expected 'src dst'"),
    (["tfidf", "{dir}/missing.txt"], 1, b"error"),
])
def test_refused_invocations_exit_as_in_jax(files, capfdbinary, argv, rc, msg):
    argv = [a.format(**{k: str(v) for k, v in files.items()}) for a in argv]
    rc_j, _ = _run(capfdbinary, jcli.main, argv + ["--backend", "cpu"])
    rc_t, out = _run(capfdbinary, tcli.main, argv + ["--backend", "cpu"])
    assert rc_t == rc_j == rc and msg in out.err and out.out == b""


def test_subcommands_run_on_cuda_by_default(files, capfdbinary, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["index", files["text"]], ["pagerank", files["edges"]]):
        rc, out = _run(capfdbinary, tcli.main, argv)
        assert rc == 1 and b"CUDA is not available" in out.err
