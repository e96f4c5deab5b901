#!/usr/bin/env python3
"""The control of a cell's ``correct``: the plain reference put in the
program's place with its counts held in 16 bits (the configuration
states 32), run through the cell's own closed loop, check and result
line.  Its line has to read ``correct: false``.

    python3 benchmark/control.py --workload NAME --seconds S SEED [SEED ...]

Needs no card: every job of the window counts the cell's whole corpus
file with the reference, and the harness checks those answers as it
checks the program's.  Prints per seed the check lines on stderr and the
result line, with the seed, on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import corpus, harness  # noqa: E402
from benchmark.drivers import common  # noqa: E402
from benchmark.reference import wordcount as reference  # noqa: E402

CONTROL_BITS = 16


def control_job(ctx: harness.Context, path: str):
    """A job of the window with the control in the program's place."""
    size = os.path.getsize(path)
    lines = size // corpus.line_bytes(ctx.config["corpus"])
    blocks = -(-lines // ctx.config["engine"]["block_lines"])

    def job(i: int) -> dict:
        with open(path, "rb") as f:
            got = reference.wordcount(f.read(), ctx.config["semantics"], CONTROL_BITS)
        return dict(bytes=size, blocks=blocks, truncated=False, pairs=sorted(got.items()))

    return job


def control_line(workload: str, seed: int, seconds: float, config: dict | None = None) -> dict:
    """The result line of one run of ``workload`` with the control in the
    program's place; ``config`` replaces the cell's configuration (the
    tests' smaller corpus)."""
    man = harness.manifest()
    cell, cell_config, traffic = harness.resolve(man, workload)
    config = cell_config if config is None else config
    with tempfile.TemporaryDirectory(prefix="bench-control-") as wd:
        ctx = harness.Context(workload=workload, cell=cell, config=config, traffic=traffic,
                              seed=seed, seconds=seconds, trace=False, device="cpu",
                              workdir=wd)
        path = os.path.join(wd, "corpus.txt")
        corpus.write_corpus(path, config, seed)
        loop = common.closed_loop(ctx, control_job(ctx, path), trace_jobs=0)
        out = common.finish_closed(ctx, loop, None, 0, corpus_path=path, count=1)
    for c in out["checks"]:
        print(f"check {c.name}: {c.value} (limit {c.limit})", file=sys.stderr)
    return harness.result_line(man, ctx, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("seeds", type=int, nargs="+")
    args = p.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = control_line(args.workload, seed, args.seconds)
        print(json.dumps(dict(line, workload=args.workload, seed=seed,
                              seconds=round(time.perf_counter() - t0, 3))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
