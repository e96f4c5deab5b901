"""Process-wide structured tracer: nested named spans + instant events,
exported as Chrome-trace/Perfetto JSON.

Port of ``locust_tpu/obs/trace.py``:

  * spans and instants are stamped with ``time.perf_counter_ns``, one
    monotonic clock (the one ``torch.profiler`` and the benchmark time
    with), and become epoch microseconds only when exported
    (``to_chrome``/``serialize``), through the anchor pair
    ``(time.time, perf_counter)`` taken when the tracer is made, so a
    cross-node merge is still a clock-offset shift; spans are Chrome
    ``"ph": "X"`` complete events, instants ``"ph": "i"``;
  * each span names its ``parent`` in its args: the innermost span open
    on the same thread when it opened (none for a root span);
  * ``spans()`` hands the recorded spans to code in the same process on
    ``time.perf_counter`` seconds;
  * with ``profiler_ranges`` set, each span also opens a
    ``torch.profiler.record_function`` of its name, so a profiler's
    export shows the spans over the kernels they launched;
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

    __slots__ = ("_tracer", "_name", "_sync", "_args", "_t0", "_open", "_range")

    def __init__(self, tracer: "Tracer", name: str, sync, args: dict):
        self._tracer = tracer
        self._name = name
        self._sync = sync
        self._args = args
        self._range = None

    def __enter__(self):
        self._open = self._tracer._open_spans()
        if self._open:
            self._args["parent"] = self._open[-1]._name
        self._open.append(self)
        if self._tracer.profiler_ranges:
            # torch is loaded wherever a profiler runs; importing it here
            # keeps ``obs`` (and the serve control plane that imports it)
            # free of torch at import.
            import torch

            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        for ref in self._sync:
            if ref.device.type == "cuda":
                import torch

                torch.cuda.synchronize(ref.device)  # locust: noqa[R003] profiler span boundary (JAX obs/trace.py:78): the sync IS the measurement
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        # Spans close in the order they opened on a thread; remove this
        # one wherever it sits, so a span left open elsewhere (in a
        # suspended generator) cannot pop another's entry.
        if self._open[-1] is self:
            self._open.pop()
        else:
            self._open.remove(self)
        self._tracer._complete(self._name, self._t0, t1 - self._t0, self._args)
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
        # Open a torch.profiler.record_function per span (the CLI sets
        # it when a profiler runs beside the tracer).
        self.profiler_ranges = False
        self._lock = threading.Lock()
        # Records keep "ts"/"dur" in integer perf_counter nanoseconds;
        # the anchor maps them to epoch microseconds at export.
        self._events: list[dict] = []
        self._anchor_epoch_ns = time.time_ns()
        self._anchor_perf_ns = time.perf_counter_ns()
        self._pids: dict[str, int] = {process: 0}
        self._tids: dict[int, int] = {}
        self._local = threading.local()
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
                    "ts": time.perf_counter_ns(),
                    "pid": 0,
                    "tid": self._tid_locked(),
                    "args": args,
                }
            )

    def _open_spans(self) -> list:
        """This thread's stack of open spans, innermost last."""
        stack = getattr(self._local, "spans", None)
        if stack is None:
            stack = self._local.spans = []
        return stack

    def _complete(self, name: str, t0_ns: int, dur_ns: int, args: dict):
        with self._lock:
            self._events.append(
                {
                    "name": name,
                    "cat": "locust",
                    "ph": "X",
                    "ts": t0_ns,
                    "dur": dur_ns,
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

    def spans(self, thread: int | None = None) -> list[tuple]:
        """The recorded spans as ``(name, t0, t1, tid, args)``, ``t0`` and
        ``t1`` in ``time.perf_counter`` seconds, in the order they
        closed; with ``thread`` (a ``threading.get_ident()``), only the
        spans that thread recorded."""
        with self._lock:
            tid = None if thread is None else self._tids.get(thread, -1)
            return [
                (e["name"], e["ts"] / 1e9, (e["ts"] + e.get("dur", 0)) / 1e9, e.get("tid"),
                 e.get("args", {}))
                for e in self._events
                if e.get("ph") == "X" and (tid is None or e["tid"] == tid)
            ]

    def _exported(self, e: dict) -> dict:
        """A record with its times in epoch microseconds."""
        e = dict(e)
        if "ts" in e:
            e["ts"] = round((e["ts"] - self._anchor_perf_ns + self._anchor_epoch_ns) / 1e3, 1)
        if "dur" in e:
            e["dur"] = round(e["dur"] / 1e3, 1)
        return e

    # ------------------------------------------------------- cross-node merge

    def serialize(self) -> list[dict]:
        """The span/event list for the wire, in epoch microseconds
        (metadata rows excluded — the ingesting side assigns its own pid +
        process_name)."""
        with self._lock:
            return [self._exported(e) for e in self._events if e.get("ph") != "M"]

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
                    # Onto this tracer's clock: epoch us -> perf_counter ns.
                    ts = (round((float(e["ts"]) - offset_s * 1e6) * 1e3)
                          - self._anchor_epoch_ns + self._anchor_perf_ns)
                    merged = dict(e, pid=pid, ts=ts)
                    if "dur" in e:
                        merged["dur"] = round(float(e["dur"]) * 1e3)
                except (KeyError, TypeError, ValueError, OverflowError):
                    continue
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
            events = [self._exported(e) for e in self._events]
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
