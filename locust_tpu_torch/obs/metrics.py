"""Closed-registry metrics: counters, gauges and histograms.

Port of ``locust_tpu/obs/metrics.py``.  The registry is
``locust_tpu_torch.obs.names`` (one dict for spans, events AND metrics);
an unregistered or kind-mismatched name raises on the enabled path.  The
histogram keeps streaming moments (count/sum/min/max) without bucket
configuration.

Thread-safe under one lock (stream folds and the async checkpoint writer
emit concurrently); the zero-overhead disabled path lives in
``locust_tpu_torch.obs.__init__``.
"""

from __future__ import annotations

import threading

from locust_tpu_torch.obs import names as _names


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, dict] = {}

    def inc(self, name: str, n: float = 1) -> None:
        _names.check(name, "counter")
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set(self, name: str, value: float) -> None:
        _names.check(name, "gauge")
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        _names.check(name, "histogram")
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = {
                    "count": 0, "sum": 0.0, "min": value, "max": value,
                }
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)

    def snapshot(self) -> dict:
        """One JSON-able view (the trace's otherData)."""
        with self._lock:
            hists = {
                k: dict(
                    h,
                    sum=round(h["sum"], 3),
                    min=round(h["min"], 3),
                    max=round(h["max"], 3),
                    mean=round(h["sum"] / h["count"], 3) if h["count"] else 0.0,
                )
                for k, h in self._hists.items()
            }
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": hists,
            }
