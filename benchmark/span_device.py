"""Device time of a ``torch.profiler`` Chrome trace by the program's span
open when each op was launched.

A device op (a kernel, a copy or a set) and the host call that launched
it share the profiler's ``correlation`` id.  Each op's time inside the
``bench.window`` annotation goes to the innermost of the given host
spans open at its launch: of those that hold the launch, the one that
opened last.  Ops launched under none of them, or whose launch the
trace lacks, go to no span.  The spans are ``(name, t0, t1)`` on
``time.perf_counter``, placed on the trace's clock by the annotation's
start, as ``frozen/profile.py`` places the benchmark's own spans.
"""

from __future__ import annotations

import json

from benchmark.frozen import profile

# Chrome-trace categories of host calls that launch device work.
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def device_seconds_by_span(path: str, window_t0: float, spans) -> dict[str, float]:
    """Device seconds by span name in the export at ``path``; ``window_t0``
    is the host clock when the ``bench.window`` annotation opened.  Empty
    when the trace holds no window or no attributed op."""
    with open(path, encoding="utf-8") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "ts" in e]
    wins = [e for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == profile.WINDOW]
    if not wins:
        return {}
    ws = float(wins[0]["ts"])
    we = ws + float(wins[0].get("dur", 0))
    shift = ws - window_t0 * 1e6
    placed = [(n, a * 1e6 + shift, b * 1e6 + shift) for n, a, b in spans]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    out: dict[str, float] = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in profile.DEVICE_CATS or corr not in launched:
            continue
        s, t = max(float(e["ts"]), ws), min(float(e["ts"]) + float(e.get("dur", 0)), we)
        at = launched[corr]
        holding = [(a, n) for n, a, b in placed if a <= at < b]
        if t <= s or not holding:
            continue
        name = max(holding)[1]
        out[name] = out.get(name, 0.0) + (t - s) / 1e6
    return out
