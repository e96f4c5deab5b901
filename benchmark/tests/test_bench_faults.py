"""A run with the timed path broken underneath reads ``correct: false``.

Each test drives a whole tiny run on the CPU through the harness (the
look for a card skipped) with one fault planted in the port: a fold that
returns its state unchanged, half of every block's lines left out, and
an answer altered where it is produced.  A clean run of each cell reads
``correct: true`` beside them."""

import pytest
import torch

from benchmark.tests import bench_rig

CELLS = ["wc-zipf30k-batch", "wc-zipf30k-stream"]


def plant_unchanged_state(mp, workload):
    from locust_tpu_torch.engine import MapReduceEngine

    def fold_block(self, acc, lines):
        zero = torch.zeros((), dtype=torch.int32, device=lines.device)
        return acc, zero, zero

    mp.setattr(MapReduceEngine, "fold_block", fold_block)


def plant_half_batch(mp, workload):
    from locust_tpu_torch.engine import MapReduceEngine

    orig = MapReduceEngine.fold_block

    def fold_block(self, acc, lines):
        lines = lines.clone()
        lines[lines.shape[0] // 2:] = 0
        return orig(self, acc, lines)

    mp.setattr(MapReduceEngine, "fold_block", fold_block)


def plant_altered_answer(mp, workload):
    from locust_tpu_torch import engine

    orig = engine.finalize_host_pairs

    def finalize(*a, **kw):
        pairs = orig(*a, **kw)
        return [(k, v + 1) if i == 0 else (k, v) for i, (k, v) in enumerate(pairs)]

    mp.setattr(engine, "finalize_host_pairs", finalize)


FAULTS = {"unchanged_state": plant_unchanged_state, "half_batch": plant_half_batch,
          "altered_answer": plant_altered_answer}


@pytest.mark.parametrize("workload", CELLS)
def test_clean_run_is_correct(workload):
    line, _ = bench_rig.run_tiny(workload)
    assert line["correct"], line["checks"]
    assert line["checks"]["wrong_keys"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_reads_incorrect(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch, workload)
    line, _ = bench_rig.run_tiny(workload)
    assert not line["correct"], line["checks"]
    assert line["checks"]["wrong_keys"]["value"] > 0
