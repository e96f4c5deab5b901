"""PyTorch port, the mesh apps through the plan compiler and the CLI:
``python -m locust_tpu_torch index --mesh`` prints the bytes of ``python
-m locust_tpu index --mesh`` (the postings do not depend on the world's
size) in a world of one in this process and in a world of 2 processes
(``--coordinator/--num-processes/--process-id``); ``pagerank --mesh`` in
a world of 2 prints JAX's ``ShardedPageRank`` on ``make_mesh(2)``,
rendered by ``rank_row``; only process 0 prints.  The compiled mesh
plans (``compile_plan(..., mesh=True)``) against JAX's on a mesh of the
same size, including WordCount under ``hasht`` (the optimizer's fused
rewrite, demoted on a CPU rank as on JAX's CPU mesh), the refusals of
``run_stream`` and of the tf fold, and the pod flags' validation."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os
import subprocess
import sys

import numpy as np
import pytest

from locust_tpu import apps as japps
from locust_tpu import cli as jcli
from locust_tpu import plan as jplan
from locust_tpu.config import EngineConfig as JConfig
from locust_tpu.parallel import mesh as jmesh
from locust_tpu.plan.compile import compile_plan as jcompile
from locust_tpu.plan.compile import rank_row
from locust_tpu_torch import cli as tcli
from locust_tpu_torch import plan as tplan
from locust_tpu_torch.config import EngineConfig as TConfig
from locust_tpu_torch.parallel.mesh import free_port, shutdown
from locust_tpu_torch.plan.compile import compile_plan as tcompile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "sample_corpus.txt")
SMALL = ["--block-lines", "64"]
CFG = {"block_lines": 16, "line_width": 64, "emits_per_line": 8}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_apps_cli")
    text = d / "c.txt"
    with open(CORPUS, "rb") as f:
        text.write_bytes(b"".join(f.read().splitlines(keepends=True)[:400]))
    rng = np.random.default_rng(11)
    n, e = 1500, 7000
    src = rng.integers(0, n, e)
    src[src % 5 == 0] = 7  # dangling nodes
    dst = rng.zipf(1.4, e) % n
    edges = d / "e.txt"
    edges.write_text("# seeded\n" + "".join(f"{a} {b}\n" for a, b in zip(src, dst)))
    return {"text": str(text), "edges": str(edges), "dir": d, "src": src, "dst": dst, "n": n}


@pytest.fixture
def jax_mesh_of(monkeypatch):
    """JAX's ``make_mesh()`` (all devices) made a mesh of ``n`` devices,
    the size of the port's world."""
    real = jmesh.make_mesh

    def of(n):
        monkeypatch.setattr(jmesh, "make_mesh", lambda n_devices=None, **k: real(n, **k))

    return of


@pytest.fixture
def own_world():
    """A world of one formed in this process by a compiled mesh plan is
    left again at the end of the test."""
    yield
    shutdown()


def _run(capfdbinary, main, argv):
    rc = main(argv)
    return rc, capfdbinary.readouterr()


def _world(files, n, argv, tag):
    """``argv`` as ``n`` processes of ``python -m locust_tpu_torch`` joined
    through the pod flags; returns each process's exit code and stdout."""
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    outs = [files["dir"] / f"{tag}.{i}.out" for i in range(n)]
    procs = []
    for i in range(n):
        with open(outs[i], "wb") as o, open(str(outs[i])[:-4] + ".err", "wb") as e:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "locust_tpu_torch", *argv, "--backend", "cpu",
                 "--coordinator", coord, "--num-processes", str(n), "--process-id", str(i)],
                env=env, stdout=o, stderr=e))
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, [o.read_bytes() for o in outs]


@pytest.mark.parametrize("lpd", ["1", "3"])
def test_index_mesh_world_of_one_prints_the_jax_cli_bytes(files, capfdbinary, lpd):
    argv = ["index", files["text"], "--mesh", "--lines-per-doc", lpd, *SMALL,
            "--backend", "cpu"]
    rc, want = _run(capfdbinary, jcli.main, argv)
    assert rc == 0
    rc, got = _run(capfdbinary, tcli.main, argv)
    assert rc == 0 and got.out == want.out and got.out.count(b"\n") > 500


def test_index_mesh_world_of_two_prints_the_jax_cli_bytes(files, capfdbinary):
    argv = ["index", files["text"], "--mesh", "--lines-per-doc", "4", *SMALL]
    rc, want = _run(capfdbinary, jcli.main, argv + ["--backend", "cpu"])
    rcs, outs = _world(files, 2, argv, "index2")
    assert rc == 0 and rcs == [0, 0]
    assert outs[0] == want.out and outs[1] == b""


def test_pagerank_mesh_world_of_two_equals_jax_sharded(files):
    argv = ["pagerank", files["edges"], "--mesh", "--num-iters", "12"]
    rcs, outs = _world(files, 2, argv, "pagerank2")
    ranks = japps.ShardedPageRank(jmesh.make_mesh(2), files["n"]).run(
        files["src"], files["dst"], num_iters=12)
    want = b"".join(rank_row(i, ranks[i]) for i in range(files["n"]))
    assert rcs == [0, 0] and outs[0] == want and outs[1] == b""


def test_pagerank_mesh_world_of_one_prints_the_jax_cli_bytes(files, capfdbinary, jax_mesh_of):
    jax_mesh_of(1)
    argv = ["pagerank", files["edges"], "--mesh", "--top", "40", "--backend", "cpu"]
    rc, want = _run(capfdbinary, jcli.main, argv)
    assert rc == 0
    rc, got = _run(capfdbinary, tcli.main, argv)
    assert rc == 0 and got.out == want.out and got.out.count(b"\n") == 40


@pytest.mark.parametrize("argv,msg", [
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "0"],
     b"require --mesh"),
    (["--mesh", "--coordinator", "127.0.0.1:1"], b"go together"),
])
def test_pod_flags_are_validated(files, capfdbinary, argv, msg):
    for cmd, f in (("index", files["text"]), ("pagerank", files["edges"])):
        rc, out = _run(capfdbinary, tcli.main, [cmd, f, *argv, "--backend", "cpu"])
        assert rc == 2 and msg in out.err and out.out == b""


def _lines():
    with open(CORPUS, "rb") as f:
        return f.read().splitlines()[:300]


@pytest.mark.parametrize("mode", ["lex", "hasht", "bitonic"])
def test_mesh_wordcount_plan_equals_jax(jax_mesh_of, own_world, mode):
    jax_mesh_of(1)
    jcfg, tcfg = JConfig(**CFG, sort_mode=mode), TConfig(**CFG, sort_mode=mode)
    want = jcompile(jplan.wordcount_plan(), jcfg, mesh=True).run(_lines())
    cp = tcompile(tplan.wordcount_plan(), tcfg, mesh=True, device="cpu")
    got = cp.run(_lines())
    assert got.output == want.output and len(got.output) > 1000
    assert (got.distinct, got.truncated, got.overflow_tokens) == \
        (want.distinct, want.truncated, want.overflow_tokens)
    # hasht rewrites to fused on the mesh too; a CPU rank demotes it.
    assert cp.optimized.fuse_kernel == (mode == "hasht")


def test_mesh_plans_refuse_as_jax(own_world):
    cases = [
        lambda p, c, cfg: c(p.tfidf_plan(2), cfg, mesh=True),
        lambda p, c, cfg: c(p.wordcount_plan(), cfg, mesh=True).run_stream(iter(())),
    ]
    for case in cases:
        with pytest.raises(jplan.PlanError) as theirs:
            case(jplan, jcompile, JConfig(**CFG))
        with pytest.raises(tplan.PlanError) as ours:
            case(tplan, lambda *a, **k: tcompile(*a, device="cpu", **k), TConfig(**CFG))
        assert str(ours.value) == str(theirs.value)


def test_mesh_plan_skips_the_sub_plan_cache(own_world):
    from locust_tpu_torch.serve.cache import SubPlanCache

    corpus = b"".join(ln + b"\n" for ln in _lines())
    cache = SubPlanCache()
    cp = tcompile(tplan.wordcount_plan(), TConfig(**CFG), mesh=True, device="cpu")
    first = cp.run_corpus(corpus, sub_cache=cache)
    again = cp.run_corpus(corpus, sub_cache=cache)
    assert first.output == again.output
    assert cache.stats()["entries"] == 0
