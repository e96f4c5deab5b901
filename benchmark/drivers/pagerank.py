"""Closed loop of whole PageRank jobs over a Graph500 Kronecker graph held
on the card: the traffic kind ``pagerank``.

Set-up makes the configuration's ``graph`` from the seed on the run's
device, once (``benchmark/graph.py``): int64 ``src`` and ``dst`` columns
holding both arcs of every edge.  The graph's facts (nodes, arcs,
isolated nodes, the largest in-degree, the rows of more than 64 in-arcs)
go to the run's log and record.  Each job is the port's plan path on
that graph, as a graph-analytics user runs it once the graph is loaded::

    compile_plan(pagerank_plan(num_iters, damping)).run(
        (src, dst), num_nodes=2**scale, render=False)

its in-edge grouping, its iterations and its float32 ranks brought to
the host; one client, jobs back to back (``common.closed_loop``), each
job's ranks handed on as bytes.  A job's bytes are 16 an arc (its two
int64 ids), so ``job_MBps`` is the arcs' bytes over every job of the
window over the window's time.

With ``--trace 1`` the port's tracer is on from the window's first job:
each job's record holds its ``pagerank.prep`` and ``pagerank.grouping``
spans (``prep_ms``, ``grouping_ms``), its ``pagerank.iteration`` spans
(``iteration_us``), its count of ``pagerank.iterations`` and its
gather-add launches; the profiled job's spans join the run's host spans,
so the profile's idle gaps are named by them.  A program without those
spans or that counter leaves them out of the record.

After the window: the memory peak, the profile, the program's state
freed, then every distinct answer compared with the float64 reference
(``reference/pagerank.py``) run on the same device, under the
configuration's ``limits``: ``rank_rel_err_max``, ``rank_l1_err``,
``nonfinite_ranks``.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from benchmark import graph, harness
from benchmark.drivers import common
from benchmark.reference import pagerank as reference

# An arc's bytes: its source and destination as int64.
ARC_BYTES = 16
# The port's spans a job's record keeps, summed, in ms.
SPAN_MS = {"pagerank.prep": "prep_ms", "pagerank.grouping": "grouping_ms"}
ITERATION = "pagerank.iteration"
COUNTER = "pagerank.iterations"


def _counter():
    """The port's ``pagerank.iterations`` so far; None when not counted."""
    from locust_tpu_torch import obs

    return obs.metrics_snapshot().get("counters", {}).get(COUNTER)


def program_numbers(t0: float, count0) -> tuple[dict, list]:
    """The job's numbers from the port's tracer (its spans on this thread
    since ``t0``, the counter's rise from ``count0``) and those spans;
    nothing with the tracer off."""
    from locust_tpu_torch import obs

    tracer = obs.current()
    if tracer is None:
        return {}, []
    spans = [(n, a, b) for n, a, b, _, _ in tracer.spans(thread=threading.get_ident())
             if a >= t0]
    out = {key: sum(b - a for n, a, b in spans if n == name) * 1e3
           for name, key in SPAN_MS.items() if any(n == name for n, _, _ in spans)}
    iters = [round((b - a) * 1e6, 1) for n, a, b in spans if n == ITERATION]
    if iters:
        out["iteration_us"] = iters
    count = _counter()
    if count is not None:
        out["iterations"] = int(count - (count0 or 0))
    return out, spans


def make_job(ctx: harness.Context, src, dst):
    from locust_tpu_torch import obs
    from locust_tpu_torch.ops.kernels.pagerank import gather_add
    from locust_tpu_torch.plan import pagerank_plan
    from locust_tpu_torch.plan.compile import compile_plan

    alg = ctx.config["algorithm"]
    num_nodes = 1 << ctx.config["graph"]["scale"]
    size = ARC_BYTES * int(src.shape[0])
    traced_jobs = ctx.traffic["trace_jobs"]

    def job(i: int) -> dict:
        if i == 0 and ctx.trace:
            obs.enable(process="bench")
        spans = common.JobSpans(ctx)
        launches, count0, t0 = gather_add.launches, _counter(), time.perf_counter()
        with spans.span("job"):
            plan = compile_plan(pagerank_plan(num_iters=alg["iterations"],
                                              damping=alg["damping"]), device=ctx.device)
            ranks = plan.run((src, dst), num_nodes=num_nodes, render=False).value
        numbers, own = program_numbers(t0, count0)
        if 0 <= i < traced_jobs:
            for name, a, b in own:
                ctx.spans.add(name, a, b)
        return dict(bytes=size, pairs=ranks.tobytes(), **spans.ms, **numbers,
                    gather_add_launches=gather_add.launches - launches)

    return job


def check(ctx: harness.Context, answers: common.Answers, want: np.ndarray) -> list:
    """The worst of each comparison over the window's distinct answers,
    each against the configuration's limit."""
    worst: dict = {}
    for d in answers.distinct:
        for k, v in reference.compare(np.frombuffer(d, np.float32), want).items():
            worst[k] = max(worst.get(k, v), v)
    limits = ctx.config["limits"]
    return [harness.Check(k, worst[k], limits[k]["limit"])
            for k in ("rank_rel_err_max", "rank_l1_err", "nonfinite_ranks")]


def run(ctx: harness.Context) -> dict:
    from locust_tpu_torch import obs

    cfg = ctx.config
    alg, num_nodes = cfg["algorithm"], 1 << cfg["graph"]["scale"]
    t0 = time.perf_counter()
    src, dst = graph.kronecker_arcs(cfg["graph"], ctx.seed, ctx.device)
    facts = graph.facts(src, dst, num_nodes)
    ctx.log(f"graph: {facts}; made in {time.perf_counter() - t0:.3f} s")
    loop = common.closed_loop(ctx, make_job(ctx, src, dst), ctx.traffic["trace_jobs"])
    peak = common.memory_peak(ctx)
    trace = None
    if loop["profiler"] is not None:
        trace = loop["profiler"].summary(os.path.join(ctx.workdir, "trace.json"))
        loop["profiler"] = None
    if ctx.trace:
        obs.disable()
    common.free_device(ctx)
    t0 = time.perf_counter()
    want = reference.pagerank(src, dst, num_nodes, alg["iterations"], alg["damping"])
    want = want.cpu().numpy()
    ctx.log(f"reference: {num_nodes} ranks in {time.perf_counter() - t0:.3f} s")
    del src, dst
    checks = check(ctx, loop["answers"], want)
    records = loop["records"]
    if trace is not None:
        traced = records[:loop["traced_jobs"]]
        trace["launches"] = {"gather_add": sum(r["gather_add_launches"] for r in traced)}
        if all("iterations" in r for r in traced):
            trace["iterations"] = sum(r["iterations"] for r in traced)
    device = common.device_info(ctx, 1, peak)
    record = {"jobs": records, "trace": trace, "config": cfg, "graph": facts,
              "device_name": device["kind"]}
    return {"attempted": len(records), "failed": 0, "setup_s": loop["setup_s"],
            "e2e": {ctx.traffic["metric"]: loop["job_MBps"]}, "record": record,
            "checks": checks, "device": device}
