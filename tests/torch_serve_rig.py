"""Shared pieces of the port's serve tests (tests/test_torch_serve_*.py):
the small shapes, the corpora, the oracle, a JAX daemon and a port
daemon under one ServeConfig, the simulated kill -9, and the views of a
reply or a stats dict that two daemons must agree on exactly."""

import contextlib
import copy

from helpers import py_wordcount

from locust_tpu.serve import ServeClient as JClient
from locust_tpu.serve import ServeConfig as JConfig
from locust_tpu.serve import ServeDaemon as JDaemon
from locust_tpu_torch.serve import ServeClient as TClient
from locust_tpu_torch.serve import ServeConfig as TConfig
from locust_tpu_torch.serve import ServeDaemon as TDaemon

SECRET = b"serve-test"

# tests/test_serve.py's shapes: the default sort mode ("hash") runs no
# kernel, so both packages fold 8-line blocks cheaply.
CFG_OVR = {"block_lines": 8, "line_width": 64, "key_width": 16, "emits_per_line": 8}
# The kernels' shapes: block lines a multiple of 64 and width 128, so
# JAX runs its Pallas kernels in interpret mode and engages "fused".
KCFG_OVR = {"block_lines": 64, "line_width": 128, "key_width": 16, "emits_per_line": 8}

CORPUS_A = b"alpha beta gamma\nbeta gamma delta\ngamma delta alpha\n" * 4
CORPUS_B = b"zeta eta theta\niota kappa zeta\n" * 6


def oracle(corpus: bytes, key_width: int = 16, emits: int = 8) -> dict:
    return dict(py_wordcount(corpus.splitlines(), max_tokens_per_line=emits,
                             key_width=key_width))


def start(pkg: str, **cfg_kw):
    """A daemon of ``pkg`` ("jax" or "torch", the latter on the CPU)
    serving in a thread, and its client."""
    if pkg == "jax":
        d = JDaemon(secret=SECRET, cfg=JConfig(**cfg_kw))
        client = JClient
    else:
        d = TDaemon(secret=SECRET, cfg=TConfig(**cfg_kw), device="cpu")
        client = TClient
    d.serve_in_thread()
    return d, client(d.addr, SECRET, timeout=60.0)


@contextlib.contextmanager
def pair(jax_kw=None, torch_kw=None, **cfg_kw):
    """A JAX and a port daemon under the same config (plus per-package
    extras, e.g. their own warm or journal dirs); closed at exit."""
    jd, jc = start("jax", **cfg_kw, **(jax_kw or {}))
    try:
        td, tc = start("torch", **cfg_kw, **(torch_kw or {}))
        try:
            yield (jd, jc), (td, tc)
        finally:
            td.close()
    finally:
        jd.close()


def abandon(daemon):
    """kill -9 of an in-process daemon of either package: stop its
    threads without close() (no drain, no warm flush, no compaction)."""
    daemon._shutdown.set()
    with daemon._lock:
        daemon._closed = True
    daemon.scheduler.stop()
    shipper = getattr(daemon, "shipper", None)
    if shipper is not None:
        # A dead process ships nothing: the standby must see silence.
        shipper.stop()
    daemon._sock.close()


RESULT_KEYS = ("status", "state", "cache", "plan", "distinct", "truncated",
               "overflow_tokens", "pairs")


def result_view(res: dict) -> dict:
    """What two daemons' answers to the same job must share (no job ids,
    no latencies)."""
    return {k: res.get(k) for k in RESULT_KEYS}


def error_view(exc) -> tuple:
    return (exc.code, exc.reply.get("status"), exc.reply.get("state"))


_VOLATILE = {
    (): ("uptime_s",),
    ("journal",): ("path", "append_ms_total", "append_ms_mean", "spill_ms_mean",
                   "last_compact_t"),
    ("warm",): ("path",),
    ("replication", "standby"): ("contact_age_s",),
}


def key_tree(d):
    """The nested keys of a reply (leaves collapsed)."""
    if isinstance(d, dict):
        return {k: key_tree(v) for k, v in d.items()}
    return None


def stats_view(st: dict) -> dict:
    """A stats reply without its clocks and paths: every counter two
    daemons fed the same submits must agree on."""
    st = copy.deepcopy(st)
    for path, keys in _VOLATILE.items():
        node = st
        for p in path:
            node = node.get(p) if isinstance(node, dict) else None
        if isinstance(node, dict):
            for k in keys:
                node.pop(k, None)
    return st


# --------------------------------------------------------- worker pools

POOL_RIG = dict(max_queue=16, max_batch=4, dispatch_poll_s=0.02, retry_base_s=0.02)


def start_workers(pkg: str, n: int = 2) -> list:
    """``n`` serve workers of ``pkg`` in threads (the port's on the CPU)."""
    if pkg == "jax":
        from locust_tpu.distributor.worker import Worker

        ws = [Worker(secret=SECRET, serve=True) for _ in range(n)]
    else:
        from locust_tpu_torch.distributor.worker import Worker

        ws = [Worker(secret=SECRET, serve=True, device="cpu") for _ in range(n)]
    for w in ws:
        w.serve_in_thread()
    return ws


def stop_workers(ws) -> None:
    for w in ws:
        w._shutdown.set()
        try:
            w._sock.close()
        except OSError:
            pass


def roster(ws) -> tuple:
    return tuple(f"127.0.0.1:{w.addr[1]}" for w in ws)


@contextlib.contextmanager
def pool(pkg: str, n_workers: int = 2, workers_pkg: str | None = None, **cfg_kw):
    """A daemon of ``pkg`` over ``n_workers`` in-thread serve workers of
    ``workers_pkg`` (default: the same package); yields (daemon, workers,
    client) and closes them at exit."""
    ws = start_workers(workers_pkg or pkg, n_workers)
    try:
        d, c = start(pkg, workers=roster(ws), **{**POOL_RIG, **cfg_kw})
        try:
            yield d, ws, c
        finally:
            d.close()
    finally:
        stop_workers(ws)


def settle(client, timeout: float = 30.0) -> None:
    """Until the daemon's pool holds no placement (a finished job's slot
    is released just after its answer)."""
    import time

    deadline = time.monotonic() + timeout
    while any(client.stats()["pool"]["inflight"]):
        assert time.monotonic() < deadline, "pool placements still held"
        time.sleep(0.005)


def run_wait(client, corpus: bytes, config=None, **kw) -> tuple[dict, dict]:
    """Submit, wait, settle: (result, status)."""
    ack = client.submit(corpus=corpus, config=config or CFG_OVR, **kw)
    res = client.wait(ack["job_id"], timeout=120.0)
    st = client.status(ack["job_id"])
    settle(client)
    return res, st


def worker_index(daemon, placed_on: str):
    """A ``placed_on`` answer as the worker's roster index (or as is)."""
    names = [w.name for w in daemon.pool.workers]
    return names.index(placed_on) if placed_on in names else placed_on


# --------------------------------------------------- high availability


@contextlib.contextmanager
def ha_pair(tmp_path, primary_pkg: str = "torch", standby_pkg: str = "torch",
            standby_kw=None, primary_kw=None):
    """A primary of ``primary_pkg`` shipping its journal to a hot standby
    of ``standby_pkg``; yields (primary, standby), closed at exit (a
    daemon the body abandoned is closed already: close() is then a no-op)."""
    standby, _ = start(standby_pkg, journal_dir=str(tmp_path / f"{standby_pkg}-standby-journal"),
                       standby_of="127.0.0.1:9", dispatch_poll_s=0.02,
                       **(standby_kw or {}))
    try:
        primary, _ = start(primary_pkg,
                           journal_dir=str(tmp_path / f"{primary_pkg}-primary-journal"),
                           ship_to=f"{standby.addr[0]}:{standby.addr[1]}",
                           dispatch_poll_s=0.02, ship_heartbeat_s=0.2, retry_base_s=0.02,
                           **(primary_kw or {}))
        try:
            yield primary, standby
        finally:
            primary.close()
    finally:
        standby.close()


def wait_replicated(standby, n_records: int, timeout: float = 20.0) -> None:
    """Until the standby applied ``n_records`` and holds every spill they
    reference (an applied admit is failover-safe only with its bytes)."""
    import time

    deadline = time.monotonic() + timeout
    while True:
        st = standby.receiver.stats()
        if st["applied_records"] >= n_records and st["missing_spills"] == 0:
            return
        assert time.monotonic() < deadline, f"standby never replicated: {st}"
        time.sleep(0.01)


def ship_converged(primary, standby, min_seq: int, timeout: float = 20.0) -> bool:
    """Every enqueued record acked and the standby's sequence mark at
    ``min_seq``, every spill held."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ps, ss = primary.shipper.stats(), standby.receiver.stats()
        if ps["acked_seq"] >= ps["shipped_seq"] and ss["applied_seq"] >= min_seq \
                and ss["missing_spills"] == 0:
            return True
        time.sleep(0.01)
    return False
