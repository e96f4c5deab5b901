"""Closed loop of whole streamed jobs, as ``python -m locust_tpu_torch
FILE --stream --no-timing`` runs one in process: a ``StreamingCorpus``
(the native reader) into ``plan.run_stream`` (a prefetch thread, the
staging ring, folds in flight), then ``to_host_pairs``.  Ingest overlaps
the fold, so the fold span holds the reading too."""

from __future__ import annotations

import os

from benchmark.drivers import common


def make_job(ctx, cfg, path):
    from locust_tpu_torch.io import loader
    from locust_tpu_torch.plan import wordcount_plan
    from locust_tpu_torch.plan.compile import compile_plan

    size = os.path.getsize(path)

    def job(i: int) -> dict:
        spans = common.JobSpans(ctx)
        before = common.launches()
        with spans.span("fold"):
            plan = compile_plan(wordcount_plan(), cfg, device=ctx.device)
            stream = loader.StreamingCorpus(path, cfg.line_width, cfg.block_lines)
            res = plan.run_stream(stream)
            common.sync(ctx.device)
        with spans.span("finalize"):
            pairs = res.to_host_pairs()
        counts = common.launch_delta(before)
        return dict(bytes=size, blocks=res.stream["blocks"], truncated=res.truncated,
                    overflow=res.overflow_tokens, pairs=pairs,
                    stall_ms=res.stream["backpressure_stall_ms"],
                    **spans.ms, **{f"{k}_launches": v for k, v in counts.items()})

    return job


def run(ctx):
    return common.run_single(ctx, lambda cfg, path: make_job(ctx, cfg, path))
