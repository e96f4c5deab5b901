"""Process-wide structured tracer: nested named spans + instant events,
exported as Chrome-trace/Perfetto JSON.

Port of ``locust_tpu/obs/trace.py``:

  * spans are wall-clock durations (``time.time`` epoch, so a cross-node
    merge is a clock-offset shift), recorded as Chrome ``"ph": "X"``
    complete events; instants are ``"ph": "i"``;
  * a span may carry ``sync_refs`` — tensors whose device is
    synchronised at span EXIT (``torch.cuda.synchronize`` for a CUDA
    tensor; a CPU tensor is done when its op returns), the JAX tracer's
    ``block_until_ready`` at exit;
  * names are validated against the closed registry
    (``locust_tpu_torch.obs.names``) — a typo'd name raises,
    enabled-path only;
  * ``serialize()``/``ingest()`` move span lists between processes: the
    ingesting tracer shifts them by a clock offset into one merged
    timeline (each remote process gets its own Chrome pid +
    process_name).

Thread-safe: spans/events append under one lock; tids are per-thread
Chrome thread ids.  The ZERO-overhead disabled path lives in
``locust_tpu_torch.obs.__init__`` (module hooks bail before reaching
here).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

from locust_tpu_torch.obs import names as _names


class _NullSpan:
    """Shared no-op context manager: the disabled fast path allocates
    nothing (``obs.span`` returns this singleton)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One open span; records a complete ("X") event at exit."""

    __slots__ = ("_tracer", "_name", "_sync", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, sync, args: dict):
        self._tracer = tracer
        self._name = name
        self._sync = sync
        self._args = args

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        for ref in self._sync:
            if ref.device.type == "cuda":
                # A sync ref is a torch tensor, so torch is loaded by now;
                # importing it here keeps ``obs`` (and the serve control
                # plane that imports it) free of torch at import.
                import torch

                torch.cuda.synchronize(ref.device)  # locust: noqa[R003] profiler span boundary (JAX obs/trace.py:78): the sync IS the measurement
        self._tracer._complete(
            self._name, self._t0, time.time() - self._t0, self._args
        )
        return False


class Tracer:
    """Structured span/event recorder for ONE process (or one request).

    ``trace_id`` correlates records across nodes: the master stamps it
    into map requests, workers open their request tracer with it, and the
    shipped span lists merge back under the one id.
    """

    def __init__(self, trace_id: str | None = None, process: str = "main"):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.process = process
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._pids: dict[str, int] = {process: 0}
        self._tids: dict[int, int] = {}
        self._meta_process(0, process)

    # ------------------------------------------------------------ recording

    def span(self, name: str, *sync_refs, **args) -> _Span:
        _names.check(name, "span")
        return _Span(self, name, sync_refs, args)

    def event(self, name: str, **args) -> None:
        _names.check(name, "event")
        with self._lock:
            self._events.append(
                {
                    "name": name,
                    "cat": "locust",
                    "ph": "i",
                    "s": "t",
                    "ts": round(time.time() * 1e6, 1),
                    "pid": 0,
                    "tid": self._tid_locked(),
                    "args": args,
                }
            )

    def _complete(self, name: str, t0: float, dur_s: float, args: dict):
        with self._lock:
            self._events.append(
                {
                    "name": name,
                    "cat": "locust",
                    "ph": "X",
                    "ts": round(t0 * 1e6, 1),
                    "dur": round(dur_s * 1e6, 1),
                    "pid": 0,
                    "tid": self._tid_locked(),
                    "args": args,
                }
            )

    def event_count(self) -> int:
        """Current record count — a position marker for ``annotate``'s
        ``since`` (so a join can target only records a specific run
        appended)."""
        with self._lock:
            return len(self._events)

    def annotate(self, name: str, extra: dict, since: int = 0) -> int:
        """Merge ``extra`` into the args of every span/event named
        ``name`` recorded at position >= ``since`` (the device-time join
        point — ``since`` keeps a capture's measurements off spans from
        earlier, unprofiled runs); returns how many records matched."""
        n = 0
        with self._lock:
            for e in self._events[since:]:
                if e.get("name") == name and e.get("ph") != "M":
                    e["args"] = {**e.get("args", {}), **extra}
                    n += 1
        return n

    def _tid_locked(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def _meta_process(self, pid: int, label: str) -> None:
        self._events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": label},
            }
        )

    # ------------------------------------------------------- cross-node merge

    def serialize(self) -> list[dict]:
        """The span/event list for the wire (metadata rows excluded — the
        ingesting side assigns its own pid + process_name)."""
        with self._lock:
            return [dict(e) for e in self._events if e.get("ph") != "M"]

    def ingest(
        self, events: list[dict], offset_s: float = 0.0, process: str = "remote"
    ) -> int:
        """Merge a remote tracer's serialized records, shifting their
        wall-clock timestamps by ``-offset_s`` into this tracer's clock
        (``offset_s`` = remote_clock - local_clock at a common instant).
        Each distinct ``process`` label gets its own Chrome pid.  Returns
        records merged; malformed entries are skipped, never raised on
        (telemetry must not take down a job)."""
        n = 0
        with self._lock:
            pid = self._pids.get(process)
            if pid is None:
                pid = self._pids[process] = max(self._pids.values()) + 1
                self._meta_process(pid, process)
            for e in events:
                if not isinstance(e, dict) or e.get("ph") not in ("X", "i"):
                    continue
                try:
                    ts = float(e["ts"]) - offset_s * 1e6
                except (KeyError, TypeError, ValueError):
                    continue
                merged = dict(e, pid=pid, ts=round(ts, 1))
                self._events.append(merged)
                n += 1
        return n

    # --------------------------------------------------------------- export

    def counts(self) -> dict:
        with self._lock:
            spans = sum(1 for e in self._events if e.get("ph") == "X")
            events = sum(1 for e in self._events if e.get("ph") == "i")
        return {"spans": spans, "events": events}

    def to_chrome(self, metrics: dict | None = None) -> dict:
        """The Chrome-trace JSON object (loadable in chrome://tracing and
        ui.perfetto.dev)."""
        with self._lock:
            events = [dict(e) for e in self._events]
        other = {"trace_id": self.trace_id, "clock": "epoch_us"}
        if metrics is not None:
            other["metrics"] = metrics
        return {"traceEvents": events, "otherData": other}

    def export(self, path: str, metrics: dict | None = None) -> dict:
        doc = self.to_chrome(metrics)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return doc
