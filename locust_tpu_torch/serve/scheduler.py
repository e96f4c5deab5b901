"""Bounded job queue with admission control + per-tenant weighted fairness.

The port's copy of the JAX package's ``serve/scheduler.py``: pure Python,
the same admission codes and the same stride-scheduled dispatch order.

Admission control (the "reject-with-reason" half of the serve tier): the
queue holds at most ``max_queue`` jobs globally and ``tenant_quota`` per
tenant — a submit past either bound is REJECTED with a structured reason
(``queue_full`` / ``tenant_quota``), never silently dropped or unboundedly
buffered (an unbounded queue turns overload into OOM + unbounded p99).

Fairness is stride scheduling (Waldspurger & Weihl, OSDI '94) over
tenants: each tenant carries a virtual time ``vt``; dispatching one of
its jobs charges ``vt += cost / weight`` where cost is the job's shape
bucket (big jobs cost proportionally more of the tenant's share) and
weight is the job's declared weight.  The dispatcher always serves the
minimum-``vt`` tenant's oldest job, so a tenant flooding the queue only
ever gets its weighted share — it cannot starve the others.  A tenant
going idle and returning re-enters at ``max(own vt, min active vt)``: no
banking unused share into a later burst.

Batching hook: ``next_batch`` picks the fair head job, then COALESCES
further queued jobs with the same ``batch_key`` — same executable
fingerprint and same shape bucket (serve/cache.py) — in fair order up to
``max_batch``, each charged to its own tenant.  One engine dispatch then
serves the whole batch (engine.run_batch), which is what makes many tiny
jobs cheap without letting them jump the fairness queue.

Thread-safe: handler threads admit/cancel, the single dispatcher thread
pops; all state mutates under one condition variable.
"""

from __future__ import annotations

import threading
import time

from locust_tpu_torch.serve.jobs import Job


class AdmitReject(Exception):
    """Admission refused; ``code`` is an ERROR_CODES entry."""

    def __init__(self, code: str, message: str):
        self.code = code
        super().__init__(message)


class FairScheduler:
    def __init__(
        self,
        max_queue: int = 64,
        max_batch: int = 8,
        tenant_quota: int | None = None,
    ):
        if max_queue < 1 or max_batch < 1:
            raise ValueError("max_queue and max_batch must be >= 1")
        self.max_queue = max_queue
        self.max_batch = max_batch
        # 0-disables convention (health_port 0 etc.): the CLI has no
        # None spelling for --tenant-quota, and a literal 0 would
        # reject every tenant's FIRST job — a daemon that starts
        # cleanly but can never accept work.
        if tenant_quota is not None and tenant_quota < 1:
            tenant_quota = None
        self.tenant_quota = tenant_quota
        self._cond = threading.Condition()
        self._pending: list[Job] = []  # submit order; fairness picks by vt
        # Backoff parking lot (docs/SERVING.md retry ladder): jobs
        # requeued after a failed dispatch wait out their not-before
        # time here, promoted into _pending by the dispatcher's next
        # poll.  Counted against max_queue and the tenant quota — a
        # retrying job still occupies its admission slot.
        self._delayed: list[tuple[float, Job]] = []
        self._vt: dict[str, float] = {}
        # Global virtual time: the vt of the most-behind tenant at each
        # dispatch, monotone.  It is the rejoin floor when the queue is
        # EMPTY — without it, a tenant joining an idle queue would enter
        # at 0 and then starve every returning tenant until their past
        # usage amortized (the inverse of the no-banked-share rule).
        self._global_vt = 0.0
        self._stopped = False
        self._paused = False
        self._admitted = 0
        self._rejected = 0
        self._dispatched = 0

    # ------------------------------------------------------------- admit

    def admit(self, job: Job) -> None:
        """Enqueue or raise ``AdmitReject`` with the structured reason."""
        with self._cond:
            if self._stopped:
                # Permanent, not transient: "queue_full" here would tell
                # a well-behaved client to back off and retry a daemon
                # that will never accept again.
                self._rejected += 1
                raise AdmitReject("shutting_down", "scheduler is shut down")
            occupied = len(self._pending) + len(self._delayed)
            if occupied >= self.max_queue:
                self._rejected += 1
                raise AdmitReject(
                    "queue_full",
                    f"queue full ({occupied}/{self.max_queue} "
                    "jobs pending); retry with backoff",
                )
            tenant = job.spec.tenant
            if self.tenant_quota is not None:
                mine = sum(
                    1 for j in self._pending if j.spec.tenant == tenant
                ) + sum(
                    1 for _, j in self._delayed if j.spec.tenant == tenant
                )
                if mine >= self.tenant_quota:
                    self._rejected += 1
                    raise AdmitReject(
                        "tenant_quota",
                        f"tenant {tenant!r} already has {mine} pending "
                        f"jobs (quota {self.tenant_quota})",
                    )
            if tenant not in self._vt or not any(
                j.spec.tenant == tenant
                for j in self._pending + [d[1] for d in self._delayed]
            ):
                # (Re)joining tenant: no banked share from idle time.
                active = [
                    self._vt[j.spec.tenant]
                    for j in self._pending
                    if j.spec.tenant in self._vt
                ]
                floor = min(active) if active else self._global_vt
                self._vt[tenant] = max(self._vt.get(tenant, 0.0), floor)
            self._pending.append(job)
            self._admitted += 1
            self._cond.notify_all()

    def requeue(self, job: Job, not_before: float = 0.0) -> bool:
        """Put an already-admitted job back for another dispatch attempt
        after ``not_before`` (monotonic).  Skips the admission caps — the
        job holds its slot from the original admit; rejecting a retry
        would double-charge the tenant.  False when the scheduler is
        stopped (the caller fails the job structured ``shutting_down``).
        """
        with self._cond:
            if self._stopped:
                return False
            tenant = job.spec.tenant
            if tenant not in self._vt:
                self._vt[tenant] = self._global_vt
            if not_before <= time.monotonic():
                self._pending.append(job)
            else:
                self._delayed.append((not_before, job))
            self._cond.notify_all()
            return True

    def expire(self, now: float) -> list[Job]:
        """Remove and return queued/retrying jobs whose deadline passed —
        the dispatcher's sweep turns them into structured
        ``deadline_exceeded`` answers (a job must never sit in the queue
        past a budget the client stopped waiting on)."""
        with self._cond:
            dead = [j for j in self._pending if j.expired(now)]
            for j in dead:
                self._pending.remove(j)
            dead_delayed = [
                (nb, j) for nb, j in self._delayed if j.expired(now)
            ]
            for item in dead_delayed:
                self._delayed.remove(item)
            return dead + [j for _, j in dead_delayed]

    # ----------------------------------------------------------- dispatch

    def _promote_ripe(self) -> None:
        """Move delayed jobs whose backoff expired into the dispatch
        pool.  Caller holds the condition."""
        if not self._delayed:
            return
        now = time.monotonic()
        ripe = [item for item in self._delayed if item[0] <= now]
        for item in ripe:
            self._delayed.remove(item)
            self._pending.append(item[1])

    def _fair_order(self) -> list[Job]:
        """Pending jobs in dispatch-fair order: tenants by vt (ties by
        name for determinism), submit order within a tenant."""
        order: dict[str, list[Job]] = {}
        for j in self._pending:
            order.setdefault(j.spec.tenant, []).append(j)
        tenants = sorted(order, key=lambda t: (self._vt.get(t, 0.0), t))
        out: list[Job] = []
        for t in tenants:
            out.extend(order[t])
        return out

    def next_batch(
        self, batch_key, timeout: float | None = None
    ) -> list[Job] | None:
        """Pop one fair, coalesced batch; None on timeout or shutdown.

        ``batch_key(job)`` maps a job to its compatibility key (same key
        = shares one compiled dispatch).  The head job is the fair pick;
        followers join in fair order only if their key matches.
        """
        batches = self.next_batches(batch_key, max_batches=1,
                                    timeout=timeout)
        return batches[0] if batches else None

    def next_batches(
        self, batch_key, max_batches: int = 1,
        timeout: float | None = None,
    ) -> list[list[Job]] | None:
        """Pop up to ``max_batches`` DISJOINT fair batches in one lock
        acquisition; None on timeout or shutdown (never ``[]``).

        The scale-out dispatcher's entry point (docs/SERVING.md): with a
        worker pool beneath it, the daemon asks for as many batches as
        it has free placement slots, so independent same-tick batches
        overlap across workers instead of serializing on one engine.
        Fairness is unchanged — each batch is picked exactly as
        ``next_batch`` would have picked it after the previous one's
        virtual-time charge, so the multi-batch pop equals N sequential
        single pops, minus the lock churn.
        """
        if max_batches < 1:
            raise ValueError("max_batches must be >= 1")
        with self._cond:
            self._promote_ripe()
            while (not self._pending or self._paused) and not self._stopped:
                if not self._cond.wait(timeout=timeout):
                    return None
                self._promote_ripe()
            if self._stopped or not self._pending or self._paused:
                # Stopped beats a non-empty queue: stop() must never be
                # answered with a fresh dispatch (close() is waiting on
                # the dispatcher with a bounded join; a cold TPU compile
                # here would blow it and race the warm-state flush).
                return None
            batches: list[list[Job]] = []
            while self._pending and len(batches) < max_batches:
                ordered = self._fair_order()
                head = ordered[0]
                key = batch_key(head)
                batch = [head]
                for j in ordered[1:]:
                    if len(batch) >= self.max_batch:
                        break
                    if batch_key(j) == key:
                        batch.append(j)
                for j in batch:
                    self._pending.remove(j)
                    w = max(j.spec.weight, 1e-6)
                    self._vt[j.spec.tenant] = (
                        self._vt.get(j.spec.tenant, 0.0) + j.bucket / w
                    )
                # The head was the most-behind tenant, so its charged vt
                # is the service time the system has actually reached
                # (within one stride) — the monotone clock idle joiners
                # floor at.
                self._global_vt = max(
                    self._global_vt, self._vt.get(head.spec.tenant, 0.0)
                )
                self._dispatched += len(batch)
                batches.append(batch)
            # Prune idle tenants whose vt is at/below the floor: their
            # rejoin would re-enter at the floor anyway, so the entry
            # carries no information — and tenant names are CLIENT
            # chosen, so an unpruned dict grows daemon memory (and every
            # stats reply) without bound.  Backoff-parked jobs count as
            # pending here: pruning a tenant whose only jobs are in
            # _delayed would re-enter it at vt 0.0 when they ripen — a
            # banked burst that wins every fair pick until it re-catches
            # the floor, the exact starvation this scheduler forbids.
            pending_tenants = {j.spec.tenant for j in self._pending} | {
                j.spec.tenant for _, j in self._delayed
            }
            for t in [
                t for t, v in self._vt.items()
                if t not in pending_tenants and v <= self._global_vt
            ]:
                del self._vt[t]
            return batches

    # ------------------------------------------------------------ control

    def cancel(self, job_id: str) -> Job | None:
        """Remove a still-queued job; returns it (caller marks the state)
        or None when it is not pending (unknown, running, or finished)."""
        with self._cond:
            for j in self._pending:
                if j.job_id == job_id:
                    self._pending.remove(j)
                    return j
            for item in self._delayed:
                if item[1].job_id == job_id:
                    self._delayed.remove(item)
                    return item[1]
            return None

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def drain(self) -> list:
        """Remove and return every pending job — the shutdown path.
        ``stop()`` makes ``next_batch`` answer None forever, so anything
        still queued would otherwise be abandoned in state "queued" with
        no structured answer.  Call after the dispatcher has exited."""
        with self._cond:
            drained = list(self._pending) + [j for _, j in self._delayed]
            self._pending.clear()
            self._delayed.clear()
            return drained

    def pause(self) -> None:
        """Hold dispatch (admission keeps working; jobs queue up) — the
        operator/test hook behind deterministic batch coalescing."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def count_rejection(self) -> None:
        """Fold an admission rejection decided OUTSIDE admit() (the
        daemon's aggregate byte cap) into the rejected stat — the
        counter must match the queue_full codes actually emitted, or an
        operator watching it concludes admission control never engaged
        while clients are being turned away."""
        with self._cond:
            self._rejected += 1

    def depth(self) -> int:
        """Pending + backoff-parked job count — the dispatcher's
        idle-tick probe (stats() builds per-tenant dicts; too heavy for
        4x/second)."""
        with self._cond:
            return len(self._pending) + len(self._delayed)

    def stats(self) -> dict:
        with self._cond:
            per_tenant: dict[str, int] = {}
            for j in self._pending:
                per_tenant[j.spec.tenant] = per_tenant.get(j.spec.tenant, 0) + 1
            return {
                "depth": len(self._pending),
                "retrying": len(self._delayed),
                "max_queue": self.max_queue,
                "max_batch": self.max_batch,
                "admitted": self._admitted,
                "rejected": self._rejected,
                "dispatched": self._dispatched,
                "pending_by_tenant": per_tenant,
                "virtual_time": dict(self._vt),
            }
