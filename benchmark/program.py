#!/usr/bin/env python3
"""The port's own telemetry in a cell's run: the ``locust_tpu_torch.obs``
spans inside the fold and its ``engine.host_syncs`` counter, grouped by
job, the per-layer numbers they give, and the profile's idle gaps named
by them.

    python3 benchmark/program.py --workload NAME --seconds S --trace 0|1 --obs 0|1 SEED ...

runs the cell's own driver (its job, closed loop, profile, reference
check and result line) once per seed, with the port's tracer enabled
after the warm job when ``--obs 1``, and prints per seed one JSON line:
the harness's line, and under ``program`` the numbers of ``READERS``, the
share of each job's ``bench.fold`` span that the program's spans cover,
and the spans and counters per job.  ``--trace 1`` profiles the first
job as the cell's traced run does; its breakdown's idle gaps are then
named by the innermost span open on the thread that dispatches to the
card, the port's or the benchmark's.  ``--trace 0 --obs 0|1`` measures
the tracer's cost on the cell's rate.

The cells' own runs (``run.py``) never enable the tracer: ``run_single``
in ``drivers/common.py`` would have to, after the warm job, with the
run's ``Spans`` a ``ProgramSpans`` and ``collect``'s result in the
record under ``program``; ``READERS`` then reads that record.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import tempfile
import threading
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402
from benchmark.drivers import common  # noqa: E402

# The span that wraps a compiled plan's whole run: the cover counts what
# the spans inside it name.
WRAPPER = "plan.run"


class ProgramSpans(harness.Spans):
    """The run's host spans: the benchmark's own, and, in ``between``,
    the port's spans recorded on the thread that made this object (the
    one that dispatches to the card) while its tracer is on.  The
    reader thread's spans name no idle gap."""

    def __init__(self):
        super().__init__()
        self.thread = threading.get_ident()

    def between(self, t0: float, t1: float) -> list[tuple[str, float, float]]:
        from locust_tpu_torch import obs

        own = super().between(t0, t1)
        tracer = obs.current()
        if tracer is None:
            return own
        return own + [(n, a, b) for n, a, b, _, _ in tracer.spans(thread=self.thread)
                      if b > t0 and a < t1]


def with_tracer(job):
    """``job`` with the port's tracer enabled as the window's first job
    starts (the warm job, -1, runs without it)."""
    from locust_tpu_torch import obs

    def traced(i: int) -> dict:
        if i == 0:
            obs.enable(process="bench")
        return job(i)

    return traced


def collect(ctx: harness.Context, records: list[dict]) -> dict | None:
    """The tracer's spans and counters, grouped by the window's jobs, then
    the tracer off; None when it was not on.  A job ends with its
    ``bench.finalize`` span; its spans are those that ended in it, split
    by thread: ``fold`` (the dispatching thread), ``other`` (the reader)."""
    from locust_tpu_torch import obs

    tracer = obs.current()
    if tracer is None:
        return None
    spans, counters = tracer.spans(), obs.metrics_snapshot().get("counters", {})
    fold_tid = {tid for _, _, _, tid, _ in tracer.spans(thread=ctx.spans.thread)}
    obs.disable()
    first = min((a for _, a, _, _, _ in spans), default=0.0)
    ends = sorted(b for n, _, b in ctx.spans.items if n == "bench.finalize" and b >= first)
    folds = [(a, b) for n, a, b in ctx.spans.items if n == "bench.fold" and b >= first]
    jobs = [{"blocks": r["blocks"], "fold_span": list(f), "fold": {}, "other": {}}
            for r, f in zip(records, folds)]
    for name, a, b, tid, _ in spans:
        k = next((j for j, end in enumerate(ends) if b <= end), None)
        if k is None or k >= len(jobs):
            continue
        group = jobs[k]["fold" if tid in fold_tid else "other"]
        group.setdefault(name, []).append([a, b])
    return {"jobs": jobs, "counters": counters,
            "blocks": sum(j["blocks"] for j in jobs)}


def cover(job: dict) -> float:
    """The share of the job's ``bench.fold`` span inside the union of the
    program's spans on the dispatching thread, ``plan.run`` left out."""
    f0, f1 = job["fold_span"]
    pieces = sorted((max(a, f0), min(b, f1)) for name, ivs in job["fold"].items()
                    if name != WRAPPER for a, b in ivs if min(b, f1) > max(a, f0))
    covered, edge = 0.0, f0
    for a, b in pieces:
        covered += max(0.0, b - max(a, edge))
        edge = max(edge, b)
    return covered / (f1 - f0)


def _durations(record: dict, name: str, group: str = "fold") -> list[list[float]]:
    """Per job, the durations (s) of the spans ``name``."""
    prog = record.get("program")
    if not prog or not prog["jobs"]:
        return []
    return [[b - a for a, b in j[group].get(name, [])] for j in prog["jobs"]]


def per_span_us(name: str):
    """Median of the span over every one in the window, in us."""

    def read(record):
        durs = [d for job in _durations(record, name) for d in job]
        return statistics.median(durs) * 1e6 if durs else None

    return read


def per_job_ms(name: str, group: str = "fold"):
    """The median job's summed time in the span, in ms (0 for a job
    without one)."""

    def read(record):
        jobs = _durations(record, name, group)
        return statistics.median(sum(j) for j in jobs) * 1e3 if jobs else None

    return read


def syncs_per_block(record):
    """``engine.host_syncs`` over the window's blocks."""
    prog = record.get("program")
    if not prog or not prog["blocks"]:
        return None
    return prog["counters"].get("engine.host_syncs", 0) / prog["blocks"]


# Per-layer number -> its reader of a record with ``program``.
READERS = {
    "fold_host_us_per_block": per_span_us("engine.fold.block"),
    "fold_map_host_us": per_span_us("engine.fold.map"),
    "fold_sort_host_us": per_span_us("engine.fold.sort"),
    "fold_reduce_host_us": per_span_us("engine.fold.reduce"),
    "fold_drain_ms": per_job_ms("engine.fold.drain"),
    "stage_blocks_ms": per_job_ms("engine.stage_blocks"),
    "host_syncs_per_block": syncs_per_block,
    "reader_read_ms.stream": per_job_ms("stream.read", "other"),
    "reader_wait_ms.stream": per_job_ms("stream.wait"),
    "host_syncs_per_block.stream": syncs_per_block,
}


def run(workload: str, seed: int, seconds: float, trace: bool, obs_on: bool,
        device: str = "cuda", config: dict | None = None) -> dict:
    """One run of ``workload``'s driver with the tracer on or off; its
    result line with ``program`` added.  ``config`` replaces the cell's
    configuration (the tests' smaller corpus)."""
    man = harness.manifest()
    cell, cell_config, traffic = harness.resolve(man, workload)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    with tempfile.TemporaryDirectory(prefix="bench-program-") as wd:
        ctx = harness.Context(workload=workload, cell=cell,
                              config=cell_config if config is None else config,
                              traffic=traffic, seed=seed, seconds=seconds, trace=trace,
                              device=device, workdir=wd, spans=ProgramSpans())

        def make_job(cfg, path):
            job = driver.make_job(ctx, cfg, path)
            return with_tracer(job) if obs_on else job

        out = common.run_single(ctx, make_job)
        prog = collect(ctx, out["record"]["jobs"])
    line = harness.result_line(man, ctx, out)
    line["forbidden"] = harness.forbidden_loaded()
    if prog is not None:
        record = dict(out["record"], program=prog)
        line["program"] = {
            "metrics": {k: r(record) for k, r in READERS.items()},
            "fold_cover": [cover(j) for j in prog["jobs"]],
            "counters": prog["counters"], "blocks": prog["blocks"],
            # Per job and span: [count, seconds].
            "jobs": [{g: {n: [len(ivs), sum(b - a for a, b in ivs)] for n, ivs in j[g].items()}
                      for g in ("fold", "other")} for j in prog["jobs"]],
        }
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--obs", type=int, choices=(0, 1), default=1)
    p.add_argument("seeds", type=int, nargs="+")
    args = p.parse_args(argv)
    print(f"[bench] card: {harness.card_report()}", file=sys.stderr, flush=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = run(args.workload, seed, args.seconds, bool(args.trace), bool(args.obs))
        line = dict(line, workload=args.workload, seed=seed, obs=args.obs, trace=args.trace,
                    wall_s=round(time.perf_counter() - t0, 3))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
