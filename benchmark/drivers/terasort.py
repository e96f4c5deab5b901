"""Closed loop of whole TeraSort jobs over ``gensort -a`` records held on the
card: the traffic kind ``terasort``.

Set-up makes the configuration's ``records`` from the seed on the run's
device, once (``benchmark/records.py``): ``[N, 100]`` uint8.  Each job is
the port's sample sort of them on a world of one, as a user sorting a
node's partition runs it::

    DistributedSort(make_mesh(), EngineConfig(key_width=12),
                    rows_per_device=N).sort_records(records, key_bytes=10)

with the configuration's skew factor and sample per rank (the app's
defaults).  A job ends when its sorted records are complete on the card;
the next job lets the last one's output go.  One client, jobs back to
back (``common.closed_loop``).  A job's bytes are 100 a record, so
``job_MBps`` is the records' bytes over every job of the window over the
window's time.

With ``--trace 1`` the port's tracer is on from the window's first job:
each job's record holds its ``sample_sort.*`` spans (``<phase>_ms``) and
the rise of its ``sample_sort.host_syncs`` and ``sample_sort.rows``
counters; the profiled job's device ops are summed by the port's span
open at their launch (``benchmark/span_device.py``).  A program without
those spans or counters leaves them out of the record.

After the window: the memory peak, the profile, the program's state
freed, then the last job's sorted records compared in full with the
plain reference (``reference/terasort.py``) on the same device, and
every job's overflow and record count summed, under the configuration's
``limits``: ``wrong_records``, ``unordered_pairs``, ``dropped_records``.
"""

from __future__ import annotations

import os
import threading
import time

from benchmark import harness, records as gensort, span_device
from benchmark.drivers import common
from benchmark.reference import terasort as reference

# The port's spans a job's record keeps, summed, in ms.
SPAN_MS = {"sample_sort.sample": "sample_ms", "sample_sort.partition": "partition_ms",
           "sample_sort.local": "local_ms", "sample_sort.records": "records_ms"}
# The port's counters a job's record keeps, as their rise over the job.
COUNTERS = {"sample_sort.host_syncs": "host_syncs", "sample_sort.rows": "rows"}


def _counters() -> dict:
    """The port's counters so far; empty when none is counted."""
    from locust_tpu_torch import obs

    got = obs.metrics_snapshot().get("counters", {})
    return {name: got[name] for name in COUNTERS if name in got}


def program_numbers(t0: float, before: dict) -> tuple[dict, list]:
    """The job's numbers from the port's tracer (its spans on this thread
    since ``t0``, the counters' rise from ``before``) and those spans;
    nothing with the tracer off."""
    from locust_tpu_torch import obs

    tracer = obs.current()
    if tracer is None:
        return {}, []
    spans = [(n, a, b) for n, a, b, _, _ in tracer.spans(thread=threading.get_ident())
             if a >= t0 and n in SPAN_MS]
    out = {key: sum(b - a for n, a, b in spans if n == name) * 1e3
           for name, key in SPAN_MS.items() if any(n == name for n, _, _ in spans)}
    out.update({COUNTERS[name]: int(v - before.get(name, 0))
                for name, v in _counters().items()})
    return out, spans


def make_job(ctx: harness.Context, records, held: dict):
    """The job: the port's ``sort_records`` of the records, its output
    kept in ``held["out"]`` until the next job starts and its port spans,
    in the traced jobs, in ``held["port_spans"]``."""
    from locust_tpu_torch import obs
    from locust_tpu_torch.apps.sample_sort import DistributedSort
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.parallel import make_mesh

    cfg = ctx.config
    eng, key_bytes = cfg["engine"], cfg["record"]["key_bytes"]
    n = int(records.shape[0])
    size = cfg["record"]["bytes"] * n
    traced_jobs = ctx.traffic["trace_jobs"]

    def job(i: int) -> dict:
        if i == 0 and ctx.trace:
            obs.enable(process="bench")
        held["out"] = None
        spans = common.JobSpans(ctx)
        before, t0 = _counters(), time.perf_counter()
        with spans.span("job"):
            sorter = DistributedSort(make_mesh(device=ctx.device),
                                     EngineConfig(key_width=eng["key_width"]), rows_per_device=n,
                                     skew_factor=eng["skew_factor"],
                                     sample_per_device=eng["sample_per_device"])
            out, overflow = sorter.sort_records(records, key_bytes=key_bytes)
            common.sync(ctx.device)
        held["out"] = out
        numbers, own = program_numbers(t0, before)
        if 0 <= i < traced_jobs:
            held["port_spans"].extend(own)
            for name, a, b in own:
                ctx.spans.add(name, a, b)
        return dict(bytes=size, pairs=None, overflow=int(overflow),
                    out_records=int(out.shape[0]), **spans.ms, **numbers)

    return job


def profile_of(ctx: harness.Context, loop: dict, port_spans: list) -> dict | None:
    """The traced window's summary, with the device seconds of the ops
    launched under each of the port's spans (``span_seconds``)."""
    prof = loop["profiler"]
    if prof is None:
        return None
    prof.stop()
    path = os.path.join(ctx.workdir, "trace.json")
    prof.prof.export_chrome_trace(path)
    try:
        from benchmark.frozen import profile

        trace = profile.summarize(path, prof.t0, ctx.spans.between(prof.t0, prof.t1))
        if trace is not None:
            trace["span_seconds"] = span_device.device_seconds_by_span(path, prof.t0,
                                                                       port_spans)
    finally:
        os.remove(path)
    loop["profiler"] = None
    return trace


def run(ctx: harness.Context) -> dict:
    from locust_tpu_torch import obs
    from locust_tpu_torch.parallel import mesh

    cfg = ctx.config
    n, rec = cfg["records"], cfg["record"]
    held = {"out": None, "port_spans": []}
    t0 = time.perf_counter()
    records = gensort.gensort_records(n, ctx.seed, ctx.device)
    common.sync(ctx.device)
    ctx.log(f"records: {n} of {rec['bytes']} bytes made in {time.perf_counter() - t0:.3f} s")
    loop = common.closed_loop(ctx, make_job(ctx, records, held), ctx.traffic["trace_jobs"])
    peak = common.memory_peak(ctx)
    trace = profile_of(ctx, loop, held["port_spans"])
    if ctx.trace:
        obs.disable()
    got = held.pop("out")
    mesh.shutdown()
    common.free_device(ctx)
    t0 = time.perf_counter()
    want = reference.terasort(records, rec["key_bytes"])
    got_vs = reference.compare(got, want, rec["key_bytes"])
    ctx.log(f"reference: {n} records sorted and compared in {time.perf_counter() - t0:.3f} s; "
            f"{got_vs}")
    del got, want, records
    jobs = loop["records"]
    dropped = sum(j["overflow"] + max(n - j["out_records"], 0) for j in jobs)
    limits = cfg["limits"]
    values = {"wrong_records": got_vs["wrong_records"],
              "unordered_pairs": got_vs["unordered_pairs"], "dropped_records": dropped}
    checks = [harness.Check(k, values[k], limits[k]["limit"]) for k in values]
    if trace is not None:
        trace["jobs"] = loop["traced_jobs"]
    device = common.device_info(ctx, 1, peak)
    record = {"jobs": jobs, "trace": trace, "config": cfg, "device_name": device["kind"],
              "records": {"n": n, "record_bytes": rec["bytes"], "key_bytes": rec["key_bytes"]}}
    return {"attempted": len(jobs), "failed": 0, "setup_s": loop["setup_s"],
            "e2e": {ctx.traffic["metric"]: loop["job_MBps"]}, "record": record,
            "checks": checks, "device": device}
