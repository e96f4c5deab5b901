"""Snapshot publishing and the bounded background checkpoint writer.

Port of ``locust_tpu/io/snapshot.py`` without its telemetry spans and
fault-injection sites (those come with the port's obs and fault tiers).

* ``finalize_snapshot`` publishes a fully written temporary file with one
  atomic ``os.replace``, keeping the previous generation when asked.
* ``AsyncCheckpointWriter``: the fold loop only marks a generation (a
  device copy of the table and a closure that writes it); one daemon
  thread runs the closures strictly in order, one pending generation
  deep, latest wins.  A writer error is raised on the submitting thread
  at the next ``submit()`` or ``flush()``.
"""

from __future__ import annotations

import logging
import os
import threading
import time

logger = logging.getLogger("locust_tpu_torch")


def finalize_snapshot(tmp: str, path: str, prev_path: str | None = None) -> None:
    """Publish the fully written ``tmp`` at ``path`` atomically; with
    ``prev_path``, the generation it replaces moves there first."""
    if prev_path is not None and os.path.exists(path):
        os.replace(path, prev_path)
    os.replace(tmp, path)


class AsyncCheckpointWriter:
    """Bounded background snapshot writer, one pending generation deep.

    ``submit(generation, write_fn)`` replaces any still-pending generation
    and returns at once; the daemon thread runs ``write_fn()`` (which waits
    for its data on the device, copies it to the host, serializes and
    publishes).  ``flush()`` waits until nothing is pending or running and
    re-raises a recorded error; ``close()`` flushes within a bound and
    stops the thread, never raising.  ``stats()`` has the JAX writer's
    keys: ``submitted``, ``written``, ``skipped`` (replaced while
    pending), ``abandoned`` (0: the port injects no writer crash) and
    ``max_lag`` (generations the newest mark ran ahead of a snapshot when
    it was published)."""

    def __init__(self, name: str = "ckpt-writer"):
        self._cond = threading.Condition()
        self._pending: tuple[int, object] | None = None
        self._busy = False
        self._closed = False
        self._error: BaseException | None = None
        self._submitted = 0
        self._written = 0
        self._skipped = 0
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
                "abandoned": 0,
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
            error = None
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - relayed to the submitter
                error = e
                logger.warning(
                    "async checkpoint write failed at generation %d (%s: %s)",
                    generation, type(e).__name__, e,
                )
            with self._cond:
                self._busy = False
                if error is not None:
                    self._error = error
                else:
                    self._written += 1
                    self._max_lag = max(self._max_lag, self._latest_gen - generation)
                self._cond.notify_all()
