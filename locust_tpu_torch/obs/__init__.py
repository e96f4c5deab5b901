"""locust_tpu_torch.obs — telemetry: tracing and metrics.

Port of the core of ``locust_tpu/obs``: a process-wide ``Tracer`` with
nested named spans + instant events, a closed-registry ``Metrics``
surface and Chrome-trace/Perfetto export, validated against the port's
own copy of the trace schema (``obs/schema.py``).  The name registry is
``obs/names.py``, the JAX package's, copied whole.  The xplane device-time
attribution (``locust_tpu/obs/attribution.py``) is not ported.

ZERO-overhead disabled contract: telemetry is OFF by default, and every
module hook below bails before allocating anything — ``span()`` returns
one shared null context manager, ``event``/``metric_*`` return after a
thread-local peek + one global load.  Enable with ``obs.enable()`` (CLI:
``--trace-out FILE``; API: ``EngineConfig(trace=True)``); the engine and
plan call sites stay in the code permanently and cost nothing when
disabled (tests/test_torch_obs.py).

Scoping: ``scoped(tracer)`` pushes a thread-local override (``None``
masks the global tracer), so a request-scoped tracer records without
cross-talk from a tracer enabled in the same process.
"""

from __future__ import annotations

import contextlib
import threading

from locust_tpu_torch.obs.metrics import Metrics
from locust_tpu_torch.obs.names import NAMES  # noqa: F401 - public registry
from locust_tpu_torch.obs.trace import NULL_SPAN, Tracer

_TRACER: Tracer | None = None
_METRICS: Metrics | None = None
_TLS = threading.local()


def enable(process: str = "main", trace_id: str | None = None) -> Tracer:
    """Turn the process tracer + metrics on (idempotent: an existing
    tracer is kept so nested enables share one timeline)."""
    global _TRACER, _METRICS
    if _TRACER is None:
        _TRACER = Tracer(trace_id=trace_id, process=process)
        _METRICS = Metrics()
    return _TRACER


def disable() -> None:
    global _TRACER, _METRICS
    _TRACER = None
    _METRICS = None


def current() -> Tracer | None:
    """The tracer this thread records into: the innermost ``scoped``
    override if any (``None`` = masked off), else the process tracer."""
    stack = getattr(_TLS, "stack", None)
    if stack:
        return stack[-1]
    return _TRACER


@contextlib.contextmanager
def scoped(tracer: Tracer | None):
    """Thread-local tracer override for the block (None masks telemetry
    entirely: untraced work must not leak its spans into a tracer
    enabled in the same process)."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(tracer)
    try:
        yield tracer
    finally:
        stack.pop()


# ------------------------------------------------------------- emit hooks
#
# Call sites stay one line and permanently in the code; each hook's first
# statements bail on "disabled" before allocating.


def span(name: str, *sync_refs, **args):
    t = current()
    if t is None:
        return NULL_SPAN
    return t.span(name, *sync_refs, **args)


def event(name: str, **args) -> None:
    t = current()
    if t is None:
        return
    t.event(name, **args)


def _metrics_here() -> Metrics | None:
    """Metrics are PROCESS-scoped (one snapshot per exported timeline),
    so they record only for threads whose current tracer IS the process
    tracer: a ``scoped(None)`` mask suppresses them like spans, and a
    request-scoped tracer must not count its work into this process's
    totals.  Globals are read ONCE into locals — a concurrent
    ``disable()`` must make hooks no-ops, never AttributeError.
    """
    m, t = _METRICS, _TRACER
    if m is None or current() is not t:
        return None
    return m


def metric_inc(name: str, n: float = 1) -> None:
    m = _metrics_here()
    if m is not None:
        m.inc(name, n)


def metric_set(name: str, value: float) -> None:
    m = _metrics_here()
    if m is not None:
        m.set(name, value)


def metric_observe(name: str, value: float) -> None:
    m = _metrics_here()
    if m is not None:
        m.observe(name, value)


# ----------------------------------------------------------------- readout


def metrics_snapshot() -> dict:
    return _METRICS.snapshot() if _METRICS is not None else {}


def summary() -> dict:
    """Compact enabled-state readout."""
    if _TRACER is None:
        return {"enabled": False}
    return {
        "enabled": True,
        "trace_id": _TRACER.trace_id,
        **_TRACER.counts(),
        "metrics": metrics_snapshot(),
    }


def export(path: str) -> dict | None:
    """Write the process tracer's merged timeline (+ metrics snapshot)
    as Chrome-trace JSON; returns the document, or None when disabled."""
    if _TRACER is None:
        return None
    return _TRACER.export(path, metrics=metrics_snapshot())
