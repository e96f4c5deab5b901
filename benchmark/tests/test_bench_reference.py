"""The plain reference: its bulk path against its own one-record
definition, against a run of the port at a tiny corpus on the CPU, and
its control (counts in 16 bits) read as wrong."""

import collections
import copy

import numpy as np
import pytest
import torch

from benchmark import corpus, harness
from benchmark.reference import wordcount as ref

torch.set_num_threads(1)
_, CONFIG, _ = harness.resolve(harness.manifest(), "wc-zipf30k-batch")
SEM = CONFIG["semantics"]

TRICKY = (b"a,b c\n" + b"x" * 40 + b" y\n" + b" ".join(b"t%d" % i for i in range(25)) + b"\n"
          + b"q " * 70 + b"\n\n\r\n" + b"mid\rcr\x00nul\tt\n" + b"w" * 130 + b"\n"
          + b"\xff\xfe hi-there (x)\n" + b"last")


def by_line(text: bytes) -> dict:
    c = collections.Counter(k for ln in text.split(b"\n") for k in ref.count_line(ln, SEM))
    return dict(c)


def test_bulk_path_equals_the_per_record_definition():
    assert ref.wordcount(TRICKY, SEM) == by_line(TRICKY)
    rng = np.random.default_rng(3)
    alphabet = np.frombuffer(b"ab ,.\n\r\x00-" + b"c" * 8, np.uint8)
    for _ in range(5):
        text = alphabet[rng.integers(0, alphabet.size, 20000)].tobytes()
        assert ref.wordcount(text, SEM) == by_line(text)


def test_wrap_and_compare():
    assert ref.wrap(32768, 16) == -32768 and ref.wrap(70000, 16) == 70000 - 65536
    assert ref.wrap(2**31, 32) == -(2**31) and ref.wrap(5, 32) == 5
    assert ref.compare([(b"a", 1), (b"b", 2)], {b"a": 1, b"b": 2}) == 0
    assert ref.compare([(b"a", 1), (b"c", 2)], {b"a": 2, b"b": 2}) == 3


def port_pairs(text: bytes, path) -> list:
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.io import loader
    from locust_tpu_torch.plan import wordcount_plan
    from locust_tpu_torch.plan.compile import compile_plan

    path.write_bytes(text)
    cfg = EngineConfig(**dict(CONFIG["engine"], block_lines=64))
    rows = loader.load_rows(str(path), cfg.line_width)
    res = compile_plan(wordcount_plan(), cfg, device="cpu").run(
        rows, timed=False, render=False, finalize=False).run_result
    return res.to_host_pairs()


@pytest.mark.parametrize("kind", ["tricky", "zipf"])
def test_reference_agrees_with_the_port_on_the_cpu(kind, tmp_path):
    if kind == "tricky":
        text = TRICKY * 3
    else:
        config = dict(CONFIG, corpus_bytes=80 * 600)
        text = corpus.generate_part(config, 11, 0)
    got = port_pairs(text, tmp_path / "c.txt")
    assert ref.compare(got, ref.wordcount(text, SEM)) == 0


@pytest.mark.parametrize("workload", ["wc-zipf30k-batch", "wc-zipf30k-stream"])
def test_control_in_16_bits_is_read_as_wrong(workload):
    """The control of every cell, through the cell's closed loop, check
    and result line: counts past 32,767 wrap in 16 bits.  At 40,000
    lines the corpus's first word is counted ~57,000 times."""
    from benchmark import control

    _, config, _ = harness.resolve(harness.manifest(), workload)
    config = copy.deepcopy(config)
    config["corpus_bytes"] = 80 * 40000
    line = control.control_line(workload, 2**33 + 1, 0.1, config=config)
    assert line["correct"] is False
    assert line["checks"]["wrong_keys"]["value"] > 0
    assert line["checks"]["wrong_keys"]["limit"] == 0
    text = corpus.generate_part(config, 5, 0)
    assert ref.compare(ref.wordcount(text, SEM), ref.wordcount(text, SEM)) == 0
