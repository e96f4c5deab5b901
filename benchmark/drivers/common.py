"""What the drivers share: the engine configuration, the closed loop of
whole jobs, the profiler over the traced part of the window, and the
comparison of every kept answer with the reference."""

from __future__ import annotations

import os
import time

from benchmark import harness, stats
from benchmark.frozen import profile
from benchmark.reference import wordcount as reference


def engine_config(config: dict):
    """The configuration's engine settings as the port's ``EngineConfig``."""
    from locust_tpu_torch.config import EngineConfig

    return EngineConfig(**config["engine"])


def sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


class Profiler:
    """``torch.profiler`` over the traced part of the window, opened with
    the ``bench.window`` annotation; exported and reduced after the
    window closed."""

    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.prof = None
        self.t0 = self.t1 = None
        self._annotation = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile as tprofile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = tprofile(activities=acts)
        self.prof.start()
        self._annotation = torch.profiler.record_function(profile.WINDOW)
        self.t0 = time.perf_counter()
        self._annotation.__enter__()

    def stop(self) -> None:
        if self.prof is None or self.t1 is not None:
            return
        sync(self.ctx.device)
        self._annotation.__exit__(None, None, None)
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self, path: str) -> dict | None:
        """Export the trace to ``path`` and reduce it (None when nothing
        on the device was recorded); the export is deleted after."""
        if self.prof is None:
            return None
        self.stop()
        self.prof.export_chrome_trace(path)
        try:
            return profile.summarize(path, self.t0, self.ctx.spans.between(self.t0, self.t1))
        finally:
            os.remove(path)


class Answers:
    """Every answer a window produced, each distinct one kept once."""

    def __init__(self):
        self.distinct: list[list] = []
        self.jobs: list[int] = []  # job -> index into distinct

    def add(self, pairs: list) -> None:
        for i, d in enumerate(self.distinct):
            if d == pairs:
                self.jobs.append(i)
                return
        self.distinct.append(pairs)
        self.jobs.append(len(self.distinct) - 1)

    def wrong_keys(self, want: dict) -> int:
        """Keys wrong over every job: each job counts its answer's."""
        per = [reference.compare(d, want) for d in self.distinct]
        return sum(per[i] for i in self.jobs)


def closed_loop(ctx: harness.Context, job, trace_jobs: int, go_on=None) -> dict:
    """One warm job (set-up), then jobs back to back until the window's
    seconds have passed; the window ends with the last job, so every job
    in it is whole.  With tracing, the profiler covers the first
    ``trace_jobs`` jobs of the window.  ``job(i)`` returns the job's
    record with its ``bytes`` and ``pairs``; ``go_on(t_w0)``, when
    given, decides after each job whether another follows."""
    ctx.log("warm job")
    job(-1)
    prof = Profiler(ctx) if ctx.trace else None
    records, answers = [], Answers()
    setup_s = time.perf_counter() - ctx.t_start
    if prof is not None:
        prof.start()  # takes seconds; not counted in the window
    t_w0 = time.perf_counter()
    while True:
        rec = job(len(records))
        answers.add(rec.pop("pairs"))
        records.append(rec)
        if prof is not None and len(records) == trace_jobs:
            t_stop = time.perf_counter()
            prof.stop()
            t_w0 += time.perf_counter() - t_stop  # the profiler's stop is not work
        if not (go_on(t_w0) if go_on is not None else time.perf_counter() - t_w0 < ctx.seconds):
            break
    t_w1 = time.perf_counter()
    window_s = t_w1 - t_w0
    if ctx.device.startswith("cuda"):
        ctx.log(f"card after the window: {harness.card_report()}")
    total = sum(r["bytes"] for r in records)
    ctx.log(f"window: {len(records)} jobs, {total} bytes in {window_s:.3f} s; setup {setup_s:.3f} s")
    for i, r in enumerate(records):
        ctx.log(f"job {i}: " + " ".join(f"{k}={v}" for k, v in r.items()))
    return dict(records=records, answers=answers, window_s=window_s, setup_s=setup_s,
                job_MBps=stats.rate(total, window_s) / 1e6, profiler=prof,
                traced_jobs=min(trace_jobs, len(records)))


def device_info(ctx: harness.Context, count: int, peak_bytes: int) -> dict:
    import torch

    kind = torch.cuda.get_device_name(0) if ctx.device.startswith("cuda") else "cpu"
    return {"platform": "gpu" if ctx.device.startswith("cuda") else "cpu", "kind": kind,
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def memory_peak(ctx: harness.Context) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if ctx.device.startswith("cuda") else 0


def free_device(ctx: harness.Context) -> None:
    import gc

    import torch

    gc.collect()
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()


class JobSpans:
    """A job's benchmark spans: each is recorded on the run's host
    timeline as ``bench.<name>`` and kept in the job's record as
    ``<name>_ms``."""

    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.ms: dict[str, float] = {}

    def span(self, name: str):
        import contextlib

        @contextlib.contextmanager
        def cm():
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self.ctx.spans.add(f"bench.{name}", t0, t1)
                self.ms[f"{name}_ms"] = (t1 - t0) * 1e3

        return cm()


def launches() -> dict:
    """The port's kernel launch counters (whole sorts for kernel B)."""
    from locust_tpu_torch.ops.kernels.fused_fold import fused_block_preagg
    from locust_tpu_torch.ops.kernels.sort import bitonic_sort_rows
    from locust_tpu_torch.ops.kernels.tokenize import tokenize_block_kernel

    return {"tokenize": tokenize_block_kernel.launches, "bitonic": bitonic_sort_rows.launches,
            "fused_fold": fused_block_preagg.launches}


def launch_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items()}


def run_single(ctx: harness.Context, make_job) -> dict:
    """A closed loop of whole jobs over one corpus file on one device:
    ``make_job(cfg, path)`` gives the job function.  After the window:
    the memory peak, the trace, the program's state freed, then every
    job's answer against the reference over the file."""
    from benchmark import corpus

    cfg = engine_config(ctx.config)
    path = os.path.join(ctx.workdir, "corpus.txt")
    size = corpus.write_corpus(path, ctx.config, ctx.seed)
    ctx.log(f"corpus: {size} bytes")
    loop = closed_loop(ctx, make_job(cfg, path), ctx.traffic["trace_jobs"])
    peak = memory_peak(ctx)
    trace = None
    if loop["profiler"] is not None:
        trace = loop["profiler"].summary(os.path.join(ctx.workdir, "trace.json"))
        loop["profiler"] = None
    free_device(ctx)
    return finish_closed(ctx, loop, trace, peak, corpus_path=path, count=1)


def finish_closed(ctx, loop, trace, peak, corpus_path, count, want=None) -> dict:
    """The record of a closed loop: answers checked against the reference
    over ``corpus_path`` (or ``want``, already counted)."""
    if want is None:
        with open(corpus_path, "rb") as f:
            text = f.read()
        t0 = time.perf_counter()
        want = reference.wordcount(text, ctx.config["semantics"])
        ctx.log(f"reference: {len(want)} keys in {time.perf_counter() - t0:.3f} s")
    answers = loop["answers"]
    checks = [
        harness.Check("wrong_keys", answers.wrong_keys(want), 0),
        harness.Check("truncated_jobs", sum(bool(r.get("truncated")) for r in loop["records"]), 0),
    ]
    if trace is not None:
        traced = loop["records"][:loop["traced_jobs"]]
        trace["blocks"] = sum(r["blocks"] for r in traced)
        trace["launches"] = {k: sum(r.get(f"{k}_launches", 0) for r in traced)
                             for k in ("tokenize", "bitonic", "fused_fold")}
    record = {"jobs": loop["records"], "trace": trace, "config": ctx.config,
              "device_name": device_info(ctx, count, peak)["kind"]}
    return {
        "attempted": len(loop["records"]), "failed": 0, "setup_s": loop["setup_s"],
        "e2e": {ctx.traffic["metric"]: loop["job_MBps"]}, "record": record, "checks": checks,
        "device": device_info(ctx, count, peak),
    }
