"""Reduce a ``torch.profiler`` Chrome trace to what the per-layer metrics
read: device time by op, the busy and idle share of the traced window,
and the idle gaps named by the benchmark span open on the host.

Frozen copy of the trace parse of ``locust_tpu_torch/utils/profiling.py``
(``parse_trace``: the events of the device categories, summed by name)
and of ``chip_smoke.py``'s ``profile_breakdown`` (device ops per unit of
work, the busy share of the device window), with the window taken from
the benchmark's own annotation instead of the first and last op.
"""

from __future__ import annotations

import json

from benchmark import stats

# Chrome-trace categories of device activity in a torch.profiler export.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def summarize(path: str, window_t0: float, host_spans=(), top_n: int = 10) -> dict | None:
    """The traced window of the export at ``path``.  ``window_t0`` is the
    host clock (``time.perf_counter``) when the ``bench.window``
    annotation opened; ``host_spans`` are ``(name, t0, t1)`` on that
    clock.  None when the trace holds no window or no device op."""
    with open(path, encoding="utf-8") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "ts" in e]
    wins = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not wins:
        return None
    ws = float(wins[0]["ts"])
    we = ws + float(wins[0].get("dur", 0))
    ops, op_s, op_n = [], {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        s, t = max(s, ws), min(t, we)
        if t <= s:
            continue
        ops.append((s, t))
        op_s[e["name"]] = op_s.get(e["name"], 0.0) + (t - s) / 1e6
        op_n[e["name"]] = op_n.get(e["name"], 0) + 1
    if not ops:
        return None
    busy = stats.merge_intervals(ops)
    busy_s = sum(t - s for s, t in busy) / 1e6
    # Host spans on the trace's clock: the annotation opened at window_t0.
    shift = ws - window_t0 * 1e6
    spans = sorted(((n, a * 1e6 + shift, b * 1e6 + shift) for n, a, b in host_spans),
                   key=lambda sp: sp[1])
    gaps: dict[str, float] = {}
    edge = ws
    for s, t in busy + [(we, we)]:
        if s > edge:
            mid = (edge + s) / 2
            open_ = [n for n, a, b in spans if a <= mid < b]
            name = open_[-1] if open_ else "no benchmark span"
            gaps[name] = gaps.get(name, 0.0) + (s - edge) / 1e6
        edge = max(edge, t)
    top = sorted(op_s.items(), key=lambda kv: -kv[1])[:top_n]
    return {
        "busy_s": busy_s,
        "window_s": (we - ws) / 1e6,
        "device_ops": len(ops),
        "op_seconds": op_s,
        "op_counts": op_n,
        "top_ops": [[n, s] for n, s in top],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda kv: -kv[1])[:top_n],
    }


def kernel_seconds(summary: dict, fragment: str) -> float:
    """Device seconds of the ops whose name holds ``fragment``."""
    return sum(s for n, s in summary["op_seconds"].items() if fragment in n)
