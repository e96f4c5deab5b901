"""Closed loop of whole one-shot jobs, as ``python -m locust_tpu_torch
FILE --no-timing`` runs one in process: the native ``load_rows``, then
``compile_plan(wordcount_plan(), cfg).run(rows, timed=False,
render=False)`` (its fold: ``run_fused``), then the key-sorted pairs.
The fold is timed to its device sync apart from the host decode."""

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
        with spans.span("load"):
            rows = loader.load_rows(path, cfg.line_width)
        with spans.span("fold"):
            plan = compile_plan(wordcount_plan(), cfg, device=ctx.device)
            res = plan.run(rows, timed=False, render=False, finalize=False).run_result
            common.sync(ctx.device)
        with spans.span("finalize"):
            pairs = res.to_host_pairs()
        counts = common.launch_delta(before)
        return dict(bytes=size, blocks=max(1, -(-rows.shape[0] // cfg.block_lines)),
                    truncated=res.truncated, overflow=res.overflow_tokens, pairs=pairs,
                    **spans.ms, **{f"{k}_launches": v for k, v in counts.items()})

    return job


def run(ctx):
    return common.run_single(ctx, lambda cfg, path: make_job(ctx, cfg, path))
