"""PyTorch port, CLI: ``python -m locust_tpu_torch FILE --backend cpu``
prints on stdout exactly the bytes that ``python -m locust_tpu FILE
--backend cpu`` prints, whatever the port's sort mode or stage report.
Both ``main(argv)`` run in-process."""

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


# ------------------------------------------------- every mode, staged, stream


def _jax_stdout(capfdbinary, jax_outputs, key, argv):
    """The JAX CLI's stdout for ``argv`` (on the CPU, ``hash`` mode: stdout
    does not depend on the mode), computed once per key."""
    if key not in jax_outputs:
        jax_outputs[key] = _stdout(capfdbinary, jcli.main,
                                   [*argv, "--sort-mode", "hash", "--backend", "cpu"]).out
    return jax_outputs[key]


@pytest.mark.parametrize("mode", ["lex", "hash", "hashp", "hashp2", "hash1", "radix"])
def test_cli_every_sort_mode(mode, capfdbinary, jax_outputs):
    want = _jax_stdout(capfdbinary, jax_outputs, (), [CORPUS])
    got = _stdout(capfdbinary, tcli.main,
                  [CORPUS, "--sort-mode", mode, "--block-lines", "256", "--backend", "cpu"])
    assert got.out == want and b"Process stage" in got.err


@pytest.mark.parametrize("mode", ["bitonic", "hash", "radix", "fused"])
def test_cli_staged_map_and_reduce_byte_identical_to_jax(mode, tmp_path, capfdbinary):
    """Stage 1 on two line ranges, one writing tsv and one bin, then stage
    2 on each file alone and on both (mixed formats): the intermediate
    files and every stage-2 stdout equal the JAX CLI's."""
    files = {}
    for pkg, main, extra in (("j", jcli.main, ["--sort-mode", "hash"]),
                             ("t", tcli.main, ["--sort-mode", mode, "--block-lines", "256"])):
        for part, (lo, hi, fmt) in enumerate([("0", "500", "tsv"), ("500", "-1", "bin")]):
            path = str(tmp_path / f"{pkg}{part}.{fmt}")
            out = _stdout(capfdbinary, main, [CORPUS, lo, hi, str(part), "1", "-i", path,
                                              "--inter-format", fmt, *extra, "--backend", "cpu"])
            assert out.out == b"" and b"intermediate written to" in out.err
            files[pkg, part] = path
    for part in (0, 1):
        with open(files["j", part], "rb") as fj, open(files["t", part], "rb") as ft:
            assert fj.read() == ft.read()
    for parts in ([0], [1], [0, 1], [1, 0]):
        outs = {}
        for pkg, main, extra in (("j", jcli.main, ["--sort-mode", "hash"]),
                                 ("t", tcli.main, ["--sort-mode", mode])):
            inter = [a for p in parts for a in ("-i", files[pkg, p])]
            outs[pkg] = _stdout(capfdbinary, main, [CORPUS, "0", "0", "9", "2", *inter, *extra,
                                                    "--backend", "cpu"])
        assert outs["t"].out == outs["j"].out and outs["t"].out.count(b"\n") > 100
        assert b"intermediate pairs" in outs["t"].err


@pytest.mark.parametrize("port_args", [
    ["--stream"],
    ["--stream", "--sort-mode", "fused", "--block-lines", "64", "--no-timing"],
    ["--stream", "--sort-mode", "hasht", "--block-lines", "64", "--checkpoint-dir", "{ckpt}",
     "--checkpoint-every", "3"],
    ["--checkpoint-dir", "{ckpt}", "--block-lines", "128", "--checkpoint-every", "2"],
    ["--checkpoint-dir", "{ckpt}", "--block-lines", "128", "--sync-checkpoint"],
    ["--auto-caps"],
    ["--auto-caps", "--stream", "--block-lines", "128", "--trace"],
])
@pytest.mark.parametrize("slice_args", [[], ["100", "700"]])
def test_cli_stream_checkpoint_and_auto_caps(slice_args, port_args, tmp_path, capfdbinary,
                                             jax_outputs):
    want = _jax_stdout(capfdbinary, jax_outputs, tuple(slice_args), [CORPUS, *slice_args])
    argv = [a.format(ckpt=tmp_path / "ckpt") for a in port_args]
    got = _stdout(capfdbinary, tcli.main, [CORPUS, *slice_args, *argv, "--backend", "cpu"])
    assert got.out == want
    if "--stream" in port_args:
        assert b"[locust] stream: {" in got.err
    if "--checkpoint-dir" in port_args:
        assert (tmp_path / "ckpt" / "state.npz").exists()
        again = _stdout(capfdbinary, tcli.main, [CORPUS, *slice_args, *argv, "--backend", "cpu"])
        assert again.out == want  # resumes from the finished snapshot
    if "--auto-caps" in port_args:
        assert b"auto-caps: max_token=" in got.err
    if "--trace" in port_args:
        assert b"load" in got.err and b"output" in got.err


def test_cli_stream_matches_jax_stream_with_checkpoint(tmp_path, capfdbinary, jax_outputs):
    """Both CLIs' ``--stream --checkpoint-dir`` over the same slice."""
    outs = {}
    for pkg, main in (("j", jcli.main), ("t", tcli.main)):
        outs[pkg] = _stdout(capfdbinary, main, [
            CORPUS, "50", "790", "--stream", "--block-lines", "64", "--sort-mode", "hash",
            "--checkpoint-dir", str(tmp_path / pkg), "--backend", "cpu"]).out
    assert outs["t"] == outs["j"] and outs["t"].count(b"\n") > 100
