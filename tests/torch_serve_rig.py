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
