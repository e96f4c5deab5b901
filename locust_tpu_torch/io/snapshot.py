"""Snapshot publishing and the bounded background checkpoint writer.

Port of ``locust_tpu/io/snapshot.py`` with its telemetry (the
``ckpt.write`` span and the ``ckpt.publish`` and ``ckpt.skip`` events)
and its fault sites (utils/faultplan.py).

* ``finalize_snapshot`` publishes a fully written temporary file with one
  atomic ``os.replace``, keeping the previous generation when asked.  The
  ``io.ckpt_write`` site delays the writer or crashes it between the
  temporary file and the rename (the temporary file stays behind, the
  previous generation survives); the ``io.checkpoint`` site damages the
  published file.
* ``AsyncCheckpointWriter``: the fold loop only marks a generation (a
  device copy of the table and a closure that writes it); one daemon
  thread runs the closures strictly in order, one pending generation
  deep, latest wins.  An injected writer crash (``FaultInjected``)
  abandons that snapshot and the run goes on; any other writer error is
  raised on the submitting thread at the next ``submit()`` or
  ``flush()``.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from locust_tpu_torch import obs
from locust_tpu_torch.utils import faultplan

logger = logging.getLogger("locust_tpu_torch")


def finalize_snapshot(tmp: str, path: str, prev_path: str | None = None,
                      generation: int | None = None) -> None:
    """Publish the fully written ``tmp`` at ``path`` atomically; with
    ``prev_path``, the generation it replaces moves there first.  A
    "crash" fault at ``io.ckpt_write`` raises ``FaultCrash`` before the
    rename, leaving ``tmp`` behind and ``path`` at its previous
    generation."""
    rule = faultplan.fire("io.ckpt_write", path=path, generation=generation)
    if rule is not None:
        if rule.action == "delay" and rule.delay_s > 0:
            time.sleep(rule.delay_s)
        elif rule.action == "crash":
            raise faultplan.FaultCrash(
                f"[faultplan] injected checkpoint-writer crash before rename of {path} "
                f"(generation {generation})")
    if prev_path is not None and os.path.exists(path):
        os.replace(path, prev_path)
    os.replace(tmp, path)
    # The generation is durable from this instant.
    obs.event("ckpt.publish", generation=generation, path=path)
    # Damage to the published file (no-op without a plan): loaders must
    # check it and start afresh.
    faultplan.damage_file("io.checkpoint", path)


class AsyncCheckpointWriter:
    """Bounded background snapshot writer, one pending generation deep.

    ``submit(generation, write_fn)`` replaces any still-pending generation
    and returns at once; the daemon thread runs ``write_fn()`` (which waits
    for its data on the device, copies it to the host, serializes and
    publishes).  ``flush()`` waits until nothing is pending or running and
    re-raises a recorded error; ``close()`` flushes within a bound and
    stops the thread, never raising.  ``stats()`` has the JAX writer's
    keys: ``submitted``, ``written``, ``skipped`` (replaced while
    pending), ``abandoned`` (injected writer crashes) and
    ``max_lag`` (generations the newest mark ran ahead of a snapshot when
    it was published)."""

    def __init__(self, name: str = "ckpt-writer"):
        # The tracer of the creating (fold-loop) thread: the writer's
        # ckpt.write span lands in the same timeline as the loop's marks.
        self._obs_tracer = obs.current()
        self._cond = threading.Condition()
        self._pending: tuple[int, object] | None = None
        self._busy = False
        self._closed = False
        self._error: BaseException | None = None
        self._submitted = 0
        self._written = 0
        self._skipped = 0
        self._abandoned = 0
        self._latest_gen = 0
        self._max_lag = 0
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def submit(self, generation: int, write_fn) -> None:
        """Mark ``generation`` for writing; replaces any pending mark."""
        with self._cond:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            if self._pending is not None:
                self._skipped += 1
                # Latest wins: the replaced generation never lands.
                obs.event("ckpt.skip", generation=self._pending[0], replaced_by=generation)
            self._pending = (generation, write_fn)
            self._submitted += 1
            self._latest_gen = max(self._latest_gen, generation)
            self._cond.notify_all()

    def flush(self, raise_errors: bool = True, timeout: float | None = None) -> bool:
        """Wait until the writer is idle (or ``timeout`` seconds passed);
        raise any recorded error.  Returns True if the writer is idle."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending is not None or self._busy:
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                self._cond.wait(timeout=0.5)
            if raise_errors and self._error is not None:
                err, self._error = self._error, None
                raise err
            return True

    def close(self) -> None:
        """Flush within 30 s and stop the thread; never raises.  A write
        still running then is abandoned with its daemon thread: the
        temporary-then-rename protocol leaves a complete generation."""
        if not self.flush(raise_errors=False, timeout=30.0):
            logger.warning(
                "async checkpoint writer still busy at close; abandoning the "
                "in-flight write (daemon thread)"
            )
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)

    def stats(self) -> dict:
        with self._cond:
            return {
                "submitted": self._submitted,
                "written": self._written,
                "skipped": self._skipped,
                "abandoned": self._abandoned,
                "max_lag": self._max_lag,
            }

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None:
                    return
                generation, fn = self._pending
                self._pending = None
                self._busy = True
                self._cond.notify_all()
            abandoned, error = False, None
            try:
                with obs.scoped(self._obs_tracer), obs.span("ckpt.write", generation=generation):
                    fn()
            except faultplan.FaultInjected as e:
                # The writer "died": this snapshot is lost, the previous
                # generation survives on disk, the run goes on.
                abandoned = True
                logger.warning("checkpoint writer crash injected at generation %d (%s); "
                               "snapshot abandoned", generation, e)
            except Exception as e:  # noqa: BLE001 - relayed to the submitter
                error = e
                logger.warning(
                    "async checkpoint write failed at generation %d (%s: %s)",
                    generation, type(e).__name__, e,
                )
            with self._cond:
                self._busy = False
                if abandoned:
                    self._abandoned += 1
                elif error is not None:
                    self._error = error
                else:
                    self._written += 1
                    self._max_lag = max(self._max_lag, self._latest_gen - generation)
                self._cond.notify_all()
