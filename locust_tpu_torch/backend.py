"""The dispatch circuit breaker.

Port of the part of ``locust_tpu/backend.py`` that has a CUDA
counterpart: ``CircuitBreaker`` and ``guarded_dispatch``.  Consecutive
dispatch failures on the card trip the breaker; a run that opted in
(``MapReduceEngine.run_checkpointed(breaker=...)``) reloads its last
snapshot onto the same device and waits out the cooldown for the
half-open probe.  Unlike the JAX module, nothing fails over to the CPU:
a fold on the card never continues on the CPU.  The entry points
resolve their device with ``engine.resolve_device``.

Not ported: the JAX module's subprocess probe of a remote TPU PJRT
plugin, its CPU pin and its probe markers (``probe_tpu``, ``force_cpu``,
``_unpin_platforms``, ``_eager_init``, the marker directory).  They work
around a plugin inside jax that can hang at initialisation; a CUDA
context either comes up or raises (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

import logging
import threading
import time

import torch

from locust_tpu_torch import obs
from locust_tpu_torch.ops.kernels import KernelLaunchError
from locust_tpu_torch.utils import faultplan

logger = logging.getLogger("locust_tpu_torch")

# What counts as a failed dispatch: an injected fault, a kernel launch the
# card refused, and the CUDA errors torch raises (out of memory; an
# asynchronous error surfacing at a sync, where torch has a type for it).
# Anything else (a failed build, a bug in a wrapper) is no dispatch
# failure: it propagates uncounted.
DISPATCH_ERRORS: tuple[type[BaseException], ...] = (
    faultplan.FaultInjected, KernelLaunchError, torch.cuda.OutOfMemoryError,
) + tuple(t for t in (getattr(torch, "AcceleratorError", None),) if t is not None)


class CircuitBreaker:
    """Consecutive-failure circuit breaker for dispatches on the card.

    Per-dispatch retries alone turn a failing link into a timeout ladder
    on EVERY dispatch; the breaker remembers instead (Nygard, "Release
    It!"):

      * ``closed``    dispatches on the card flow; consecutive failures
        count, a success resets the count;
      * ``open``      ``threshold`` consecutive failures trip it: the card
        is ineligible (``allow()`` is False) for ``cooldown_s``, and
        callers wait (engine.run_checkpointed sleeps it out, then
        resumes from its last checkpoint on the card);
      * ``half_open`` cooldown over: ``allow()`` returns True exactly
        ONCE (the probe dispatch); success closes the breaker, failure
        re-opens it for another full cooldown.

    Thread-safe; transitions emit ``backend.breaker_*`` instant events
    and trips count in ``backend.breaker_trips``.  ``clock`` is
    injectable for tests.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        if cooldown_s <= 0:
            raise ValueError("breaker cooldown_s must be > 0")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0       # consecutive, resets on success
        self._open_until = 0.0
        self._probing = False    # a half-open probe is in flight
        self._trips = 0
        self._successes = 0
        self._failures_total = 0

    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller dispatch on the card right now?"""
        event = None
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() < self._open_until:
                    return False
                self._state = "half_open"
                self._probing = True
                event = "half_open"
            elif self._probing:
                return False  # one probe at a time; others wait
            else:
                self._probing = True
        if event is not None:
            obs.event("backend.breaker_half_open", cooldown_s=self.cooldown_s)
        return True

    def record_success(self) -> None:
        closed = False
        with self._lock:
            self._successes += 1
            self._failures = 0
            self._probing = False
            if self._state != "closed":
                self._state = "closed"
                closed = True
        if closed:
            obs.event("backend.breaker_close")
            logger.info("backend breaker closed: the card is restored")

    def record_failure(self) -> None:
        opened = None
        with self._lock:
            self._failures += 1
            self._failures_total += 1
            if self._state == "half_open":
                # The probe failed: a full new cooldown, not a trip.
                self._state = "open"
                self._probing = False
                self._open_until = self._clock() + self.cooldown_s
                opened = "reopen"
            elif self._state == "closed" and self._failures >= self.threshold:
                self._state = "open"
                self._open_until = self._clock() + self.cooldown_s
                self._trips += 1
                opened = "trip"
        if opened is not None:
            obs.event(
                "backend.breaker_open",
                failures=self.threshold if opened == "trip" else 1,
                cooldown_s=self.cooldown_s,
            )
            if opened == "trip":
                obs.metric_inc("backend.breaker_trips")
            logger.warning(
                "backend breaker %s: the card is ineligible for %.1fs",
                "tripped" if opened == "trip" else "re-opened",
                self.cooldown_s,
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "failures": self._failures_total,
                "successes": self._successes,
                "trips": self._trips,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
            }


def guarded_dispatch(breaker: CircuitBreaker, fn, **ctx):
    """Run one dispatch on the card under the breaker's accounting.

    The ``backend.dispatch`` fault site fires here: "error" models the
    card's dispatch failing, "delay" a slow one, so the whole
    trip/half-open/close ladder is drivable from a fault plan.  An
    exception of ``DISPATCH_ERRORS`` out of ``fn`` counts as a dispatch
    failure and re-raises; any other propagates uncounted.  The caller
    decides what a failure costs (engine.run_checkpointed reloads its
    last checkpoint on the same device)."""
    rule = faultplan.fire("backend.dispatch", **ctx)
    if rule is not None:
        if rule.action == "delay":
            time.sleep(rule.delay_s)
        else:
            breaker.record_failure()
            raise faultplan.FaultInjected(
                "[faultplan] injected backend dispatch failure"
            )
    try:
        out = fn()
    except DISPATCH_ERRORS:
        breaker.record_failure()
        raise
    breaker.record_success()
    return out
