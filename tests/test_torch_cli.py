"""PyTorch port, CLI: ``python -m locust_tpu_torch FILE --backend cpu``
prints on stdout exactly the bytes that ``python -m locust_tpu FILE
--backend cpu`` prints, whatever the port's sort mode or stage report.
Both ``main(argv)`` run in-process.  The staged and streaming runs are in
tests/test_torch_cli_staged.py."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os

import pytest

from locust_tpu import cli as jcli
from locust_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "sample_corpus.txt")


def _stdout(capfdbinary, main, argv):
    assert main(argv) == 0
    return capfdbinary.readouterr()


@pytest.fixture(scope="module")
def jax_outputs():
    return {}


@pytest.mark.parametrize("slice_args", [[], ["100", "300"]])
@pytest.mark.parametrize("port_args", [
    [],
    ["--no-timing"],
    ["--sort-mode", "hashp1"],
    ["--block-lines", "256"],
    ["--sort-mode", "fused", "--no-timing"],
    ["--sort-mode", "hasht"],
    ["--sort-mode", "hasht-mxu"],
])
def test_cli_stdout_byte_identical_to_jax(slice_args, port_args, capfdbinary, jax_outputs):
    key = tuple(slice_args)
    if key not in jax_outputs:
        jax_outputs[key] = _stdout(
            capfdbinary, jcli.main, [CORPUS, *slice_args, "--backend", "cpu"]
        ).out
    got = _stdout(capfdbinary, tcli.main, [CORPUS, *slice_args, *port_args, "--backend", "cpu"])
    assert got.out == jax_outputs[key]
    assert got.out.count(b"\n") > 100
    assert b"lines loaded" in got.err
    assert (b"Process stage" in got.err) == ("--no-timing" not in port_args)


def test_cli_hasht_runs_through_the_fused_kernel(capfdbinary, monkeypatch):
    """``--sort-mode hasht`` takes the JAX compiler's wordcount rewrite to
    "fused": the fold goes through the fused kernel's wrapper per block."""
    from locust_tpu_torch.ops.kernels import fused_fold

    calls = []
    real = fused_fold.fused_preagg_reference

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(fused_fold, "fused_preagg_reference", counting)
    out = _stdout(capfdbinary, tcli.main,
                  [CORPUS, "--sort-mode", "hasht", "--no-timing", "--block-lines", "256",
                   "--backend", "cpu"])
    assert len(calls) == 4  # 820 lines in blocks of 256
    assert out.out.count(b"\n") > 100


def test_cli_limit_and_errors(capfdbinary, tmp_path):
    full = _stdout(capfdbinary, tcli.main, [CORPUS, "--backend", "cpu"]).out
    head = _stdout(capfdbinary, tcli.main, [CORPUS, "--limit", "7", "--backend", "cpu"]).out
    assert head == b"".join(full.splitlines(keepends=True)[:7])
    assert tcli.main([str(tmp_path / "missing.txt"), "--backend", "cpu"]) == 1
    assert b"error" in capfdbinary.readouterr().err
