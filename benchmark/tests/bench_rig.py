"""Tiny cells on the CPU: the manifest's cell with its corpus and blocks
shrunk, run through the harness's driver as a run on the card would be,
without the harness's look for a card."""

from __future__ import annotations

import copy
import os
import tempfile

import torch

from benchmark import harness

torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")


def tiny(workload: str, lines: int = 2000, block_lines: int = 256):
    """The cell's context pieces at a size the CPU runs in seconds."""
    cell, config, traffic = harness.resolve(harness.manifest(), workload)
    config = copy.deepcopy(config)
    parts = config["corpus"]["parts"]
    config["corpus_bytes"] = 80 * lines * parts
    config["engine"]["block_lines"] = block_lines
    return cell, config, copy.deepcopy(traffic)


def run_tiny_ctx(workload: str, seed: int = 2**33 + 5, seconds: float = 1.0,
                 trace: bool = False, **kw) -> tuple[harness.Context, dict]:
    """``(context, driver output)`` of one tiny CPU run."""
    cell, config, traffic = tiny(workload, **kw)
    with tempfile.TemporaryDirectory() as wd:
        ctx = harness.Context(workload=workload, cell=cell, config=config, traffic=traffic,
                              seed=seed, seconds=seconds, trace=trace, device="cpu",
                              workdir=wd)
        out = harness.run_cell(ctx)
    return ctx, out


def run_tiny(workload: str, **kw) -> tuple[dict, dict]:
    """``(result line, driver output)`` of one tiny CPU run."""
    ctx, out = run_tiny_ctx(workload, **kw)
    return harness.result_line(harness.manifest(), ctx, out), out
