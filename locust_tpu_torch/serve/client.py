"""Thin client for the serve daemon (serve/daemon.py).

The port's copy of the JAX package's ``serve/client.py``: the same
requests on the same wire (distributor/protocol.py), so it drives a
daemon of either package, and a JAX client drives the port's daemon.
``promote`` flips a standby daemon of either package to primary.

Speaks the distributor's authenticated frame protocol over one fresh
connection per request — stateless and retry-friendly (the daemon's
replay guard wants fresh nonces anyway; a persistent connection buys
nothing at control-plane request sizes).  ``ServeError`` carries the
daemon's structured reason code so callers can switch on ``code``
(``queue_full`` -> back off, ``bad_spec`` -> fix the request, ...).
"""

from __future__ import annotations

import base64
import socket
import time

from locust_tpu_torch.distributor import protocol
from locust_tpu_torch.utils import faultplan


class ServeError(RuntimeError):
    """A structured daemon-side error; ``code`` is an ERROR_CODES entry."""

    def __init__(self, code: str, message: str, reply: dict | None = None):
        self.code = code
        self.reply = reply or {}
        super().__init__(f"[{code}] {message}")


def _parse_addr(spec) -> tuple[str, int]:
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        return (str(spec[0]), int(spec[1]))
    host, _, port = str(spec).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"daemon address {spec!r} is not host:port")
    return (host, int(port))


# Bound on redirect-following per RPC: a not_primary chain longer than
# this is a misconfigured ring, not a failover.
_MAX_REDIRECTS = 4


class ServeClient:
    """``addr`` may be ONE address — ``(host, port)`` or ``"host:port"``
    — or a ROSTER (list/tuple of them, or a comma-separated string): the
    client tries each in order, follows a standby's structured
    ``not_primary`` redirect to the address it names, and remembers
    whichever daemon answered so ``submit``/``result``/``stats`` survive
    a takeover transparently (docs/SERVING.md "High availability")."""

    def __init__(
        self,
        addr,
        secret: bytes,
        timeout: float = 60.0,
    ):
        if isinstance(addr, str) and "," in addr:
            addr = [a.strip() for a in addr.split(",") if a.strip()]
        if isinstance(addr, str):
            roster = [_parse_addr(addr)]
        elif isinstance(addr, (list, tuple)) and len(addr) == 2 and (
            isinstance(addr[1], int)
            or (isinstance(addr[1], str) and addr[1].isdigit())
        ):
            # The legacy single-address tuple, port int OR numeric
            # string (the pre-roster constructor coerced with int()).
            roster = [_parse_addr(addr)]
        elif isinstance(addr, (list, tuple)) and addr:
            roster = [_parse_addr(a) for a in addr]
        else:
            roster = [_parse_addr(addr)]
        if not roster:
            raise ValueError("ServeClient needs at least one address")
        self.roster = roster
        self.addr = roster[0]  # the preferred (last-known-good) daemon
        self.secret = secret
        self.timeout = timeout

    # ------------------------------------------------------------ plumbing

    def _rpc_one(self, addr: tuple[str, int], req: dict) -> dict:
        faultplan.check_connect(addr[0], addr[1])
        with socket.create_connection(addr, timeout=self.timeout) as s:
            s.settimeout(self.timeout)
            protocol.send_frame(s, req, self.secret)
            return protocol.recv_frame(s, self.secret)

    def rpc(self, req: dict) -> dict:
        """One request against the roster: try the last-known-good
        daemon first, fail over to the others on connection errors, and
        follow ``not_primary`` redirects to the named primary.  The last
        connection error re-raises when nobody answers (single-address
        behavior is unchanged); a structured reply — even an error — is
        an ANSWER and returns to the caller."""
        order = [self.addr] + [a for a in self.roster if a != self.addr]
        last_err: Exception | None = None
        last_resp: dict | None = None
        redirects = 0
        i = 0
        while i < len(order):
            addr = order[i]
            i += 1
            try:
                resp = self._rpc_one(addr, req)
            except (ConnectionError, socket.timeout, OSError) as e:
                last_err = e
                continue
            if resp.get("code") == "not_primary":
                last_resp = resp
                if resp.get("primary") and redirects < _MAX_REDIRECTS:
                    redirects += 1
                    try:
                        target = _parse_addr(resp["primary"])
                    except ValueError:
                        continue
                    if target not in order:
                        order.insert(i, target)
                continue
            self.addr = addr  # sticky: later RPCs start here
            return resp
        if last_resp is not None:
            # Everyone reachable called themselves a standby: hand the
            # caller the structured not_primary answer, not a socket
            # error — the reason code is the actionable part.
            return last_resp
        raise last_err

    def _rpc_ok(self, req: dict) -> dict:
        resp = self.rpc(req)
        if resp.get("status") != "ok":
            raise ServeError(
                str(resp.get("code", "dispatch_failed")),
                str(resp.get("error", "serve request failed")),
                reply=resp,
            )
        return resp

    # ------------------------------------------------------------ commands

    def ping(self) -> bool:
        return bool(self._rpc_ok({"cmd": "ping"}).get("pong"))

    def submit(
        self,
        corpus: bytes | None = None,
        path: str | None = None,
        tenant: str = "default",
        workload: str | None = None,
        config: dict | None = None,
        weight: float = 1.0,
        invalidate: bool = False,
        no_cache: bool = False,
        deadline_s: float | None = None,
        max_attempts: int | None = None,
        plan: dict | str | None = None,
    ) -> dict:
        """Submit one job; returns the daemon's ack ({job_id, state,
        cached}).  Raises ``ServeError`` on a structured rejection.
        ``deadline_s``/``max_attempts`` are the job's robustness budgets
        (docs/SERVING.md): expiry anywhere answers ``deadline_exceeded``,
        a job that kills ``max_attempts`` dispatches is quarantined as
        ``poison_job``.  ``plan`` submits a composable dataflow plan
        (a plan document dict or its JSON text, docs/PLAN.md) instead of
        a named workload; the result is the pipeline's rendered output
        bytes as one (bytes, 0) pair, flagged ``plan`` in the reply."""
        req: dict = {
            "cmd": "submit",
            "tenant": tenant,
            "weight": weight,
        }
        if plan is not None:
            # Mirror the daemon's parse_spec rule EXACTLY (workload
            # None or the reserved "plan" name may ride a plan submit;
            # anything else is conflicting intent) instead of silently
            # dropping the caller's workload — the default is None so
            # an explicitly stated workload is always distinguishable.
            if workload not in (None, "plan"):
                raise ValueError(
                    "submit takes a plan OR a workload name, not both"
                )
            req["plan"] = plan
            # The reserved name rides ALONGSIDE the plan: a pre-plan
            # daemon ignores the unknown "plan" key, and without this it
            # would default the submit to wordcount and answer a wrong
            # but "done" table — with it, the old build rejects loudly
            # with unknown_workload (never a silent wrong answer).
            req["workload"] = "plan"
        else:
            req["workload"] = workload or "wordcount"
        if config:
            req["config"] = dict(config)
        if invalidate:
            req["invalidate"] = True
        if no_cache:
            req["no_cache"] = True
        if deadline_s is not None:
            req["deadline_s"] = deadline_s
        if max_attempts is not None:
            req["max_attempts"] = max_attempts
        if corpus is not None:
            req["corpus_b64"] = base64.b64encode(corpus).decode()
        if path is not None:
            req["path"] = path
        return self._rpc_ok(req)

    def status(self, job_id: str) -> dict:
        return self._rpc_ok({"cmd": "status", "job_id": job_id})

    def result(self, job_id: str) -> dict:
        """The finished job's decoded result: the reply dict with
        ``pairs`` as (key bytes, count) tuples.  Raises ``ServeError``
        with the job's structured code on failed/cancelled/not-done."""
        resp = self._rpc_ok({"cmd": "result", "job_id": job_id})
        resp["pairs"] = [
            (base64.b64decode(k), int(v)) for k, v in resp.get("pairs", [])
        ]
        return resp

    def wait(self, job_id: str, timeout: float = 120.0,
             poll_s: float = 0.05, max_poll_s: float = 1.0) -> dict:
        """Poll until the job leaves the queue/engine; returns
        ``result()`` on success, raises ``ServeError`` on a structured
        failure or ``TimeoutError`` when the deadline passes (a bounded
        wait — a wedged daemon must not hang the client).

        Polling backs off geometrically from ``poll_s`` to ``max_poll_s``
        with jitter: a fixed interval across N waiting clients
        synchronizes their status RPCs into daemon-hammering waves, and
        long jobs do not need 20 polls a second.  The timeout error
        carries the daemon-reported job state and attempt count — "still
        retrying (attempt 2/4)" is actionable where a bare "still
        running after Ns" is not."""
        deadline = time.monotonic() + timeout
        sleep_s = poll_s
        while True:
            st = self.status(job_id)
            if st["state"] in ("done", "failed", "cancelled"):
                return self.result(job_id)
            now = time.monotonic()
            if now >= deadline:
                attempts = st.get("attempts")
                budget = st.get("max_attempts")
                detail = f"state {st['state']!r}"
                if attempts is not None and budget is not None:
                    detail += f", attempt {attempts}/{budget}"
                if st.get("batch_size"):
                    detail += f", batch of {st['batch_size']}"
                raise TimeoutError(
                    f"job {job_id} not finished after {timeout}s "
                    f"({detail}); the daemon still holds it — poll "
                    "status/result again or raise the timeout"
                )
            # Deterministic-enough jitter without the global RNG: the
            # fractional spread only needs to decorrelate clients.
            jitter = 0.5 + (hash((job_id, now)) % 1024) / 2048.0
            time.sleep(min(sleep_s * jitter, max(deadline - now, 0.001)))
            sleep_s = min(sleep_s * 1.6, max_poll_s)

    def cancel(self, job_id: str) -> dict:
        return self._rpc_ok({"cmd": "cancel", "job_id": job_id})

    def invalidate(self, digest: str | None = None,
                   spec_fp: str | None = None,
                   job_id: str | None = None) -> int:
        req: dict = {"cmd": "invalidate"}
        if digest:
            req["digest"] = digest
        if spec_fp:
            req["spec_fp"] = spec_fp
        if job_id:
            req["job_id"] = job_id
        return int(self._rpc_ok(req).get("invalidated", 0))

    def promote(self) -> dict:
        """Promote THE FIRST ROSTER ADDRESS to PRIMARY (fenced epoch
        bump + WAL replay, docs/SERVING.md "High availability").
        Deliberately neither redirect-following nor failing-over: an
        epoch bump fences the other pair member, so it must land on
        exactly the daemon the operator named — point a single-address
        client at the standby.  A connection error raises; a primary
        answers a structured refusal."""
        resp = self._rpc_one(self.roster[0], {"cmd": "promote"})
        if resp.get("status") != "ok":
            raise ServeError(
                str(resp.get("code", "dispatch_failed")),
                str(resp.get("error", "promote failed")),
                reply=resp,
            )
        return resp

    def stats(self) -> dict:
        return self._rpc_ok({"cmd": "stats"})

    def shutdown(self) -> bool:
        return bool(self._rpc_ok({"cmd": "shutdown"}).get("bye"))
