"""Profiling: wall-clock stage spans and device-time capture.

Port of ``locust_tpu/utils/profiling.py``:

* ``SpanTimer``: named spans accumulated per name, each ending when the
  tensors passed to it are done on the device (``torch.cuda.synchronize``
  for a CUDA tensor), and a report in the JAX CLI's format.
* ``device_trace(logdir)``: a ``torch.profiler`` capture of everything
  inside the block (CUDA activity too when a card is present), exported
  as a Chrome trace into ``logdir`` on exit.
* ``profile_device(fn, out_dir)``: ``fn()`` under ``device_trace`` and a
  summary of the new trace by op family (``family_ms``), with the JAX
  function's contract: a capture or parse failure returns ``{"error":
  ...}`` and never raises, and a trace already in ``out_dir`` is never
  returned.  ``parse_trace`` replaces JAX's ``parse_xplane``: it reads the
  profiler's own Chrome-trace events, the CUDA kernels and copies when
  there are any, else the CPU's top-level ops.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time

import torch


class SpanTimer:
    """Named wall-clock spans, syncing the given tensors' devices at span
    EXIT.  Entry does not sync: device work still in flight from before
    the span is billed to it unless an earlier span synced it."""

    def __init__(self):
        self.spans_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, *sync_refs: torch.Tensor):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for ref in sync_refs:
                if ref.device.type == "cuda":
                    torch.cuda.synchronize(ref.device)
            self.spans_ms[name] = self.spans_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def report(self) -> str:
        """Spans by descending time with a percent-of-total column; ties
        break on the name, so repeated reports diff cleanly."""
        if not self.spans_ms:
            return ""
        total = sum(self.spans_ms.values())
        width = max(len(k) for k in self.spans_ms)
        rows = sorted(self.spans_ms.items(), key=lambda kv: (-kv[1], kv[0]))
        return "\n".join(
            f"{k.ljust(width)}  {v:10.3f} ms  "
            f"{(100.0 * v / total if total else 0.0):5.1f}%"
            for k, v in rows
        )


TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of everything inside the block
    (CPU ops, and CUDA kernels and copies when a card is present) and
    export it as ``<logdir>/<time>-<pid>.pt.trace.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"{time.time_ns()}-{os.getpid()}{TRACE_SUFFIX}"))


# Op-name fragments of each family (lower case), as JAX's xplane families:
# the Process-stage sort (cub's radix-sort kernels and PyTorch's own sort
# kernels, aten::sort on the CPU, kernel B's bitonic_* entry symbols);
# the hash-table fold's scatters and gathers (scatter_reduce_, index_add_
# as indexFunc*, index_put_ and indexing as index_elementwise, gather);
# the matrix products of hasht-mxu's combine; and kernel C
# (fused_preagg_kernel), which the sort family excludes so no kernel is
# counted twice in family_join.
SORT_OP_FRAGMENTS = ("sort", "bitonic")
SCATTER_OP_FRAGMENTS = ("scatter", "gather", "index_add", "index_put", "indexfunc",
                        "index_elementwise", "aten::index")
DOT_OP_FRAGMENTS = ("gemm", "aten::mm", "aten::matmul", "aten::bmm", "aten::addmm", "aten::dot")
FUSED_KERNEL_OP_FRAGMENTS = ("fused_preagg",)

# Chrome-trace categories of device activity in a torch.profiler export.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def family_ms(totals: dict, fragments, exclude=()) -> float:
    """Sum of op durations whose name carries any of ``fragments`` and
    none of ``exclude``: the one family-attribution rule."""
    return round(
        sum(
            ms
            for n, ms in totals.items()
            if any(f in n.lower() for f in fragments)
            and not any(x in n.lower() for x in exclude)
        ),
        3,
    )


def _top_level(events: list[dict]) -> list[dict]:
    """The events no other event of the same thread encloses (CPU ops
    nest: aten::sort holds its own sub-ops)."""
    out = []
    by_thread: dict[tuple, list[dict]] = {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        end = float("-inf")
        for e in sorted(evs, key=lambda e: (e["ts"], -e.get("dur", 0))):
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e.get("dur", 0)
    return out


def _summarize(totals: dict, plane: str, top_n: int = 12) -> dict:
    """The family summary of per-op-name device time ``totals`` (ms)."""
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:top_n]
    return {
        "device_plane": plane,
        "device_total_ms": round(sum(totals.values()), 3),
        "top_ops": [[n, round(ms, 3)] for n, ms in top],
        "sort_ms": family_ms(totals, SORT_OP_FRAGMENTS, exclude=FUSED_KERNEL_OP_FRAGMENTS),
        "scatter_ms": family_ms(totals, SCATTER_OP_FRAGMENTS),
        "dot_ms": family_ms(totals, DOT_OP_FRAGMENTS),
        "kernel_ms": family_ms(totals, FUSED_KERNEL_OP_FRAGMENTS),
    }


def parse_trace(path: str, top_n: int = 12) -> dict:
    """Reduce one exported Chrome trace to per-op-name duration totals
    and their families.  The device plane is ``"cuda"`` (kernels, copies
    and sets) when the trace holds device activity, else ``"cpu"`` (the
    top-level CPU ops, so nested ops are not counted twice).  Returns the
    ``_summarize`` dict, or ``{"error": ...}``."""
    try:
        with open(path, encoding="utf-8") as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "ts" in e]
    except (OSError, ValueError, KeyError, TypeError) as e:
        return {"error": f"trace parse failed: {type(e).__name__}: {e}"}
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    plane = "cuda" if device else "cpu"
    if not device:
        device = _top_level([e for e in events if e.get("cat") == "cpu_op"])
    totals: dict[str, float] = {}
    for e in device:
        totals[e["name"]] = totals.get(e["name"], 0.0) + e.get("dur", 0) / 1e3
    if not totals:
        return {"error": f"no op events in {path}"}
    return _summarize(totals, plane, top_n)


def _trace_paths(out_dir: str) -> list[str]:
    return glob.glob(os.path.join(out_dir, "**", f"*{TRACE_SUFFIX}"), recursive=True)


def newest_trace(out_dir: str, exclude=()) -> str | None:
    """Newest capture under ``out_dir``, skipping ``exclude`` paths (the
    captures that were there before a run)."""
    exclude = set(exclude)
    paths = [p for p in _trace_paths(out_dir) if p not in exclude]
    return max(paths, key=os.path.getmtime) if paths else None


def profile_device(fn, out_dir: str) -> tuple[object, dict, str | None]:
    """Run ``fn()`` under ``device_trace(out_dir)``.

    Returns ``(fn_result, summary, trace_path)``; a capture or parse
    failure returns ``summary={"error": ...}`` (result ``None`` if the
    capture itself raised).  The traces already in ``out_dir`` are listed
    before the run and never returned, so a capture that produced nothing
    reports the failure instead of an earlier run's profile."""
    try:
        os.makedirs(out_dir, exist_ok=True)
        pre_existing = set(_trace_paths(out_dir))
        with device_trace(out_dir):
            result = fn()
    except Exception as e:  # noqa: BLE001 - evidence collection never raises
        return None, {"error": f"trace failed: {type(e).__name__}: {e}"}, None
    path = newest_trace(out_dir, exclude=pre_existing)
    if path is None:
        msg = "no trace produced"
        if pre_existing:
            msg += f" (ignored {len(pre_existing)} stale capture(s) already in the output dir)"
        return result, {"error": msg}, None
    return result, parse_trace(path), path
