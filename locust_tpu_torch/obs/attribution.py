"""Device-time attribution: the profiler's op families joined onto the
Process-stage spans.

Port of ``locust_tpu/obs/attribution.py``:

* ``family_join``: the one copy of the Process-family pairing rule.  The
  sort modes pair with the sort family; the hasht family adds the
  scatters, ``hasht-mxu`` the one-hot matrix products and ``fused``
  kernel C.
* ``attributed_run``: a callable under ``utils.profiling.profile_device``;
  when a tracer is active, its ``engine.stage.process`` spans recorded
  during the capture get the measured families, and an
  ``obs.device_join`` event marks the join.

One capture has no per-stage op correlation, so the families attribute to
the Process stage, whose op families they are by construction.
``record_stage_device_row`` (the JAX evidence row) waits with
``utils/artifacts.py``, which the port does not have.
"""

from __future__ import annotations

from locust_tpu_torch import obs
from locust_tpu_torch.config import HASHT_FAMILY
from locust_tpu_torch.utils import profiling

# The stage span the device families attach to.
PROCESS_STAGE_SPAN = "engine.stage.process"


def family_join(summary: dict, sort_mode: str) -> dict:
    """Pair a ``profile_device`` ``summary`` with ``sort_mode``'s
    Process-stage op families; the same output as the JAX function for
    the same summary."""
    if summary.get("error"):
        return {"error": summary["error"]}
    sort_ms = summary.get("sort_ms")
    scatter_ms = summary.get("scatter_ms")
    dot_ms = summary.get("dot_ms")
    kernel_ms = summary.get("kernel_ms")
    family = "sort"
    process_ms = sort_ms
    if sort_mode in HASHT_FAMILY:
        process_ms = (scatter_ms or 0.0) + (sort_ms or 0.0)
        family = "scatter+sort"
        if sort_mode == "hasht-mxu":
            process_ms += dot_ms or 0.0
            family = "scatter+sort+dot"
        elif sort_mode == "fused":
            process_ms += kernel_ms or 0.0
            family = "scatter+sort+kernel"
    return {
        "process_family": family,
        "process_device_ms": round(process_ms, 3) if process_ms is not None else None,
        "sort_device_ms": sort_ms,
        "scatter_device_ms": scatter_ms,
        "dot_device_ms": dot_ms,
        "kernel_device_ms": kernel_ms,
        "device_total_ms": summary.get("device_total_ms"),
        "device_plane": summary.get("device_plane"),
    }


def attributed_run(fn, out_dir: str, sort_mode: str):
    """Run ``fn()`` under a profiler capture and join its op families onto
    the active tracer's Process-stage spans of this capture.

    Returns ``(fn_result, summary, trace_path, join)``: the first three as
    ``profiling.profile_device`` gives them (it never raises), ``join``
    from ``family_join``.  Without a tracer, or without stage spans in the
    run (``run_fused``), nothing is annotated; ``join`` carries the
    numbers either way."""
    tracer = obs.current()
    mark = tracer.event_count() if tracer is not None else 0
    result, summary, path = profiling.profile_device(fn, out_dir)
    join = family_join(summary, sort_mode)
    if tracer is not None and "error" not in join:
        # Only the spans this capture ran (since=mark).
        matched = tracer.annotate(PROCESS_STAGE_SPAN, join, since=mark)
        obs.event(
            "obs.device_join",
            stage=PROCESS_STAGE_SPAN,
            spans_annotated=matched,
            process_family=join["process_family"],
            process_device_ms=join["process_device_ms"],
        )
    return result, summary, path, join
