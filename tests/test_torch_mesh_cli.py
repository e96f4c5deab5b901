"""PyTorch port, the CLI's mesh flags: ``python -m locust_tpu_torch FILE
--mesh --backend cpu`` (a world of one rank in the CLI's process) prints
on stdout exactly the bytes of ``python -m locust_tpu FILE --mesh
--backend cpu`` (JAX's virtual CPU mesh), under each sort mode, with
``--stream`` and ``--checkpoint-dir``, and as a stage-1 intermediate; a
port world of 2 processes (``--coordinator/--num-processes/--process-id``)
and a ``--slices 2`` world print the JAX CLI's mesh report on stderr, line
for line, where the world's size equals JAX's device count (JAX in a
subprocess with 2 host devices), and only process 0 prints the table;
the pod flags without ``--mesh`` and ``--mesh`` without a card are
refused as JAX refuses them."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os
import subprocess
import sys

import pytest
import torch

from locust_tpu import cli as jcli
from locust_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "sample_corpus.txt")
SMALL = ["--block-lines", "64"]
HEAD = ["0", "400"]  # the corpus's first 400 lines


def _run(capfdbinary, main, argv):
    rc = main(argv)
    return rc, capfdbinary.readouterr()


@pytest.fixture(scope="module")
def jax_out():
    return {}


@pytest.mark.parametrize("extra", [
    ["--sort-mode", "bitonic"], ["--sort-mode", "hasht"], ["--sort-mode", "fused"],
    ["--sort-mode", "hash"], ["--slices", "1", "--sort-mode", "hasht"],
    ["--stream", "--sort-mode", "hasht"], ["--sort-mode", "lex"],
])
def test_mesh_stdout_byte_identical_to_jax(capfdbinary, jax_out, extra):
    extra = (["100", "500"] if "lex" in extra else HEAD) + extra
    args = [CORPUS, *extra, *SMALL, "--mesh", "--backend", "cpu"]
    key = tuple(a for a in extra if a not in ("--slices", "1", "--stream"))
    if key not in jax_out:
        rc, jout = _run(capfdbinary, jcli.main, [CORPUS, *key, *SMALL, "--mesh",
                                                 "--backend", "cpu"])
        assert rc == 0
        jax_out[key] = jout.out
    rc, out = _run(capfdbinary, tcli.main, args)
    assert rc == 0 and out.out == jax_out[key] and out.out.count(b"\n") > 100
    assert b"[locust] shard 0:" in out.err and b"drain_rounds=0" in out.err


def test_mesh_checkpoint_dir_and_stage1(capfdbinary, tmp_path):
    """A checkpointed mesh run, run again from its complete snapshot, and
    a stage-1 intermediate: each as the JAX CLI's."""
    base = [CORPUS, *SMALL, "--mesh", "--backend", "cpu", "--sort-mode", "hasht"]
    want = _run(capfdbinary, jcli.main, [*base[:1], *HEAD, *base[1:]])[1].out
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "3"]
    for _ in range(2):
        rc, out = _run(capfdbinary, tcli.main, [*base[:1], *HEAD, *base[1:], *ck])
        assert rc == 0 and out.out == want
    assert (tmp_path / "ck" / "state.p0.npz").exists()
    for fmt in ("tsv", "bin"):
        paths = {pkg: str(tmp_path / f"{pkg}.{fmt}") for pkg in ("jax", "torch")}
        for pkg, main in (("jax", jcli.main), ("torch", tcli.main)):
            rc, out = _run(capfdbinary, main, base[:1] + ["0", "400", "0", "1"] + base[1:]
                           + ["-i", paths[pkg], "--inter-format", fmt])
            assert rc == 0 and out.out == b""
        with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
            assert a.read() == b.read()


def test_mesh_trace_out(capfdbinary, tmp_path):
    """``--trace-out`` on a mesh run: a valid timeline with the CLI's
    load, run and output spans."""
    import json

    from locust_tpu_torch.obs.schema import validate_trace

    path = tmp_path / "mesh.trace.json"
    rc, _ = _run(capfdbinary, tcli.main, [CORPUS, *HEAD, *SMALL, "--mesh", "--backend", "cpu",
                                          "--trace-out", str(path)])
    doc = json.loads(path.read_text())
    validate_trace(doc)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert rc == 0 and {"cli.load", "cli.run", "cli.output"} <= names


def _report(err: bytes) -> list[bytes]:
    """The mesh report's lines, the run's wall time cut off."""
    return [ln.split(b" total=")[0] for ln in err.splitlines()
            if ln.startswith((b"[locust] mesh", b"[locust] hier", b"[locust] shard",
                              b"[locust] distinct")) or ln.endswith(b" lines loaded")]


def test_world_of_two_report_equals_jax_with_two_devices(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo", XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                                                   "--xla_cpu_multi_thread_eigen=false")
    from locust_tpu_torch.parallel.mesh import free_port

    runs = {}
    for name, extra in (("flat", ["--sort-mode", "hasht"]),
                        ("hier", ["--slices", "2", "--sort-mode", "hash"])):
        base = [CORPUS, *HEAD, *SMALL, "--mesh", "--backend", "cpu", *extra]
        coord = f"127.0.0.1:{free_port()}"
        procs = {f"jax_{name}": subprocess.Popen(
            [sys.executable, "-m", "locust_tpu", *base], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)}
        for pid in (0, 1):
            procs[f"torch_{name}_{pid}"] = subprocess.Popen(
                [sys.executable, "-m", "locust_tpu_torch", *base, "--coordinator", coord,
                 "--num-processes", "2", "--process-id", str(pid)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        runs.update(procs)
    got = {}
    for name, p in runs.items():
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, (name, err[-2000:])
        got[name] = (out, err)
    for name in ("flat", "hier"):
        jout, jerr = got[f"jax_{name}"]
        want = _report(jerr)
        assert len(want) == (5 if name == "flat" else 4) and want[0].startswith(b"[locust] " + (
            b"mesh: 2 device(s)" if name == "flat" else b"hierarchical mesh: 2 slice(s) x 1"))
        for pid in (0, 1):
            out, err = got[f"torch_{name}_{pid}"]
            assert _report(err) == want, (name, pid)
            # Only process 0 prints the table.
            assert out == (jout if pid == 0 else b"")


def test_refusals_equal_jax(capfdbinary, monkeypatch):
    argv = [CORPUS, "--coordinator", "127.0.0.1:9", "--num-processes", "2",
            "--process-id", "0", "--backend", "cpu"]
    jrc, jout = _run(capfdbinary, jcli.main, argv)
    rc, out = _run(capfdbinary, tcli.main, argv)
    assert rc == jrc == 2 and out.err == jout.err and out.out == b""
    assert b"require --mesh" in out.err
    # The port has no managed environment to fill in a missing count or id.
    rc, out = _run(capfdbinary, tcli.main, [CORPUS, "--mesh", "--coordinator", "127.0.0.1:9",
                                            "--backend", "cpu"])
    assert rc == 2 and b"go together" in out.err and out.out == b""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _run(capfdbinary, tcli.main, [CORPUS, "--mesh"])
    assert rc == 1 and b"CUDA is not available" in out.err and out.out == b""


def test_mesh_ranks_started_by_the_cli_import_this_checkout(monkeypatch, tmp_path):
    """``--mesh`` alone on a host with several cards starts one process
    per further card: each gets this checkout on PYTHONPATH, so it
    imports the same package whatever directory the CLI ran from."""
    from types import SimpleNamespace

    from locust_tpu_torch.parallel import mesh as mesh_mod

    started = []

    class Proc:
        def __init__(self, argv, stdout=None, env=None):
            started.append((argv, env))

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(subprocess, "Popen", Proc)
    monkeypatch.setattr(mesh_mod, "coordinator_store", lambda n: SimpleNamespace(port=1))
    monkeypatch.setattr(mesh_mod, "initialize_multihost", lambda *a: None)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    args = SimpleNamespace(coordinator=None, argv=["f.txt", "--mesh"])
    children = tcli._join_world(args, torch.device("cuda"))
    assert len(children) == 2 and len(started) == 2
    for argv, env in started:
        assert argv[1:3] == ["-m", "locust_tpu_torch"] and argv[-1] in ("1", "2")
        assert env["PYTHONPATH"].split(os.pathsep) == [REPO, str(tmp_path)]
