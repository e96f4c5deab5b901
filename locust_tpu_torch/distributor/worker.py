"""Distributor worker: the hardened descendant of the reference's slave.

Port of ``locust_tpu/distributor/worker.py``.  Same topology as the
reference slave, a TCP daemon on each node that runs the staged
MapReduce program on command (reference Distributor/slave.py:1-38), with
HMAC-authenticated frames (protocol.py), a closed command set instead of
an arbitrary ``subprocess.call(cmd[1:])``, structured status replies
instead of an unconditional "ACK", and the map's exit code propagated.

Commands: ``ping``, ``shutdown``, ``map`` (the port's stage-1 CLI in a
subprocess, ``python -m locust_tpu_torch FILE start end node 1 -i OUT``,
on CUDA unless the master's passthrough says ``--backend cpu``; maps
serialize per worker under ``_map_lock``: a node has one card) and
``fetch`` (a bounded window of an intermediate under ``workdir``, as
base64 JSON or, when the request negotiates it, a binary frame with a
raw or zlib payload).  Connections are persistent: the master pipelines
windowed fetch requests down one connection and the worker answers them
in order from one cached file handle per transfer.

The serve surface (``--serve``, docs/SERVING.md "Scale-out dispatch"):
``serve_batch`` folds one coalesced batch, or one line-range shard of a
large job, from the daemon's content-addressed corpus spill (each sha
verified before it folds) on the worker's own warm engines;
``serve_stats`` reports the shapes it holds warm; ``plan_stage`` runs one
distributed-plan stage (plan/distribute.py): a map split published as
shuffle partitions, a partition reduce, a join bin evaluated tree-deep,
or one PageRank epoch over a rank shard.  Both are epoch-fenced: a
dispatch from a primary older than one already served answers the
structured ``stale_epoch``.  The serve engines run on CUDA unless the
worker is given ``device="cpu"`` (``--backend cpu``): ``serve_batch``
folds through kernel B under ``sort_mode="bitonic"`` and kernel C under
``"fused"``, and a worker that cannot reach the card or build the kernels
does not start.  A worker started without ``--serve`` answers the three
commands with the JAX worker's structured error.

Fault sites (utils/faultplan.py): ``rpc.delay`` before a command is
handled, ``worker.map`` before a map runs, ``io.intermediate`` on a raw
fetch window, ``io.chunk`` on the encoded payload of a binary reply and
``plan.stage`` before a plan stage runs.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import zlib

from locust_tpu_torch import obs
from locust_tpu_torch.distributor import protocol
from locust_tpu_torch.utils import faultplan

# The directory holding the locust_tpu_torch package: a map subprocess
# gets it on PYTHONPATH, so ``-m locust_tpu_torch`` resolves from any cwd.
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The staged CLI a map runs: the port's, under this interpreter.
MAP_COMMAND = (sys.executable, "-m", "locust_tpu_torch")

_SERVE_DISABLED = {"status": "error",
                   "error": "serve dispatch not enabled (start with --serve)"}


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def default_map_runner(req: dict) -> dict:
    """Run the staged map through the port's CLI in a subprocess (one
    CUDA process per map)."""
    out = req.get("intermediate", os.path.join(tempfile.gettempdir(), "out.txt"))
    cmd = [
        *MAP_COMMAND,
        req["file"],
        str(req.get("line_start", -1)),
        str(req.get("line_end", -1)),
        str(req.get("node_num", 0)),
        "1",
        "-i",
        out,
    ]
    if req.get("inter_format"):  # the master's negotiated data plane
        cmd += ["--inter-format", str(req["inter_format"])]
    cmd += [str(a) for a in req.get("extra_args", [])]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p
    )
    proc = subprocess.run(cmd, capture_output=True, env=env,
                          timeout=req.get("timeout", 1800))
    return {
        "status": "ok" if proc.returncode == 0 else "error",
        "returncode": proc.returncode,
        "log": proc.stderr.decode(errors="replace")[-4000:],
        "intermediate": out,
    }


class Worker:
    """One worker daemon.  ``map_runner`` is injectable for loopback tests."""

    # Per-connection open-handle cap: a fetch transfer needs one handle;
    # a peer cycling paths on one connection must not leak descriptors.
    MAX_CACHED_FILES = 8

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        secret: bytes = b"",
        map_runner=default_map_runner,
        workdir: str | None = None,
        conn_timeout: float = 30.0,
        max_connections: int = 32,
        support_binary: bool = True,
        serve: bool = False,
        serve_max_engines: int = 4,
        device=None,
    ):
        if not secret:
            raise ValueError("worker requires a shared secret (Q8: no open RCE)")
        self.secret = secret
        self.map_runner = map_runner
        # Scale-out serve dispatch (docs/SERVING.md): with serve=True the
        # worker answers ``serve_batch`` — an in-process engine fold over
        # a coalesced job batch, behind its OWN warm-executable cache
        # (serve/cache.py), which is what makes pool cache-affinity a
        # real scheduling input.  Lazy: the cache (and torch) only enters
        # a worker that opted in.  ``device`` is the serve engines'
        # device, None = CUDA: resolved and, on CUDA, the kernels built
        # and loaded here, so no card or a failed build stops the worker
        # at start instead of failing every dispatch.
        self._serve_cache = None
        self.device = None
        if serve:
            from locust_tpu_torch.engine import resolve_device
            from locust_tpu_torch.serve.cache import ExecutableCache

            self.device = resolve_device(device)
            if self.device.type == "cuda":
                from locust_tpu_torch import _build

                _build.build()
                for name in _build.KERNEL_SOURCES:
                    _build.load(name)
            self._serve_cache = ExecutableCache(
                max_engines=serve_max_engines, device=self.device
            )
            # Tiny verified-corpus cache (sha -> split lines): a sharded
            # job sends several requests referencing ONE spill, and a
            # retried batch re-references its sha — without this every
            # request re-reads, re-hashes and re-splits the full corpus
            # on the dispatch critical path.  Content-addressed keys
            # can never go stale; 2 entries bound the memory.
            self._serve_corpus: dict[str, list] = {}
            self._serve_corpus_lock = threading.Lock()
            # Iterate-stage loop invariants (parsed edges, shard-
            # filtered columns, prep vectors) keyed by (sha, n, shard
            # layout): an N-epoch sweep sends N stage RPCs referencing
            # ONE graph — without this every epoch re-parses and
            # re-preps.  Content-addressed keys never go stale.
            self._iterate_graphs: dict[tuple, tuple] = {}
            self._iterate_lock = threading.Lock()
        # support_binary=False emulates a pre-binary (JSON-only) peer:
        # negotiation requests are ignored and every reply is a JSON frame.
        self.support_binary = support_binary
        # Fetch containment boundary is WORKER-side configuration; a request
        # must not be able to choose its own boundary.  The default is the
        # temporary directory, where the master's intermediates land.
        self.workdir = os.path.realpath(workdir or tempfile.gettempdir())
        self.conn_timeout = conn_timeout
        self._replay_guard = protocol.ReplayGuard()
        # Fencing epoch high-water mark (docs/SERVING.md "High
        # availability"): serve daemons stamp dispatches with their
        # promotion epoch; once a newer primary has dispatched here, a
        # fenced-out zombie's RPCs are rejected structured stale_epoch.
        self._epoch_guard = protocol.EpochGuard()
        self._map_lock = threading.Lock()
        # Bounded concurrency: without a cap, a peer opening idle
        # connections would spawn unbounded threads.  When the cap is
        # reached the accept loop stalls, pushing further peers into the
        # listen backlog instead of into memory.
        self._conn_slots = threading.BoundedSemaphore(max_connections)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(5)
        self.addr = self._sock.getsockname()
        self._shutdown = threading.Event()

    def serve_forever(self) -> None:
        """Accept loop: one thread per connection, so a long map does not
        block the master's pings and fetches; maps still serialize under
        ``_map_lock``."""
        while not self._shutdown.is_set():
            try:
                self._sock.settimeout(0.5)
                conn, peer = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._conn_slots.acquire()
            try:
                t = threading.Thread(
                    target=self._serve_one, args=(conn,), daemon=True
                )
                t.start()
            except Exception as e:  # noqa: BLE001 - spawn can fail under
                # thread/fd pressure; the accept loop must survive it, and
                # must not leak the slot or the connection.
                self._conn_slots.release()
                try:
                    conn.close()
                except OSError:
                    pass
                print(
                    f"[worker] connection thread spawn failed "
                    f"({type(e).__name__}: {e}); dropped conn from "
                    f"{peer}, still accepting",
                    file=sys.stderr, flush=True,
                )
        self._sock.close()

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            self._serve_conn(conn)
        finally:
            self._conn_slots.release()

    def _serve_conn(self, conn: socket.socket) -> None:
        """Serve requests on this connection until the peer closes or goes
        silent, strictly in order (the master's pipelined fetch relies on
        it).  ``files`` caches one open handle per fetched path for the
        connection's lifetime."""
        files: dict[str, tuple] = {}
        try:
            with conn:
                while not self._shutdown.is_set():
                    try:
                        # A silent peer must not hang the daemon: bound the
                        # read.  A clean close lands here too.
                        conn.settimeout(self.conn_timeout)
                        req = protocol.recv_frame(conn, self.secret)
                    except PermissionError:
                        return  # unauthenticated peer: drop silently
                    except (ConnectionError, socket.timeout, OSError):
                        return  # peer closed / idled out
                    except Exception as e:
                        # Malformed frame: the stream cannot be resynced,
                        # but the daemon survives: structured reply, drop.
                        self._try_reply(
                            conn, {"status": "error", "error": str(e)}
                        )
                        return
                    try:
                        self._replay_guard.check(req)
                        conn.settimeout(None)  # map subprocesses may run long
                        resp = self._handle(req, files)
                    except PermissionError:
                        return  # replayed frame: drop silently
                    except faultplan.FaultCrash:
                        return  # injected 'process crash': drop, no reply
                    except Exception as e:
                        resp = {"status": "error", "error": str(e)}
                    if not self._try_reply(conn, resp):
                        return
        finally:
            for fh, _ in files.values():
                try:
                    fh.close()
                except OSError:
                    pass

    def _try_reply(self, conn: socket.socket, resp) -> bool:
        """Send one reply frame: JSON, or binary when the handler returned
        a ``(meta, encoded_body, flags)`` triple.  False on a dead peer."""
        try:
            if isinstance(resp, tuple):
                meta, body, flags = resp
                protocol.send_bin_frame_encoded(
                    conn, meta, body, self.secret, flags=flags
                )
            else:
                protocol.send_frame(conn, resp, self.secret, sign_fresh=False)
            return True
        except OSError:
            return False

    def serve_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def _handle(self, req: dict, files: dict | None = None):
        cmd = req.get("cmd")
        if cmd not in protocol.COMMANDS:
            return {"status": "error", "error": f"unknown command {cmd!r}"}
        # Chaos: straggler model, the worker stalls before handling.
        faultplan.delay(
            "rpc.delay",
            cmd=cmd, shard=req.get("node_num"), port=self.addr[1],
        )
        if cmd == "ping":
            return {"status": "ok", "pong": True}
        if cmd == "shutdown":
            self._shutdown.set()
            return {"status": "ok", "bye": True}
        if cmd == "map":
            return self._traced_map(req)
        if cmd == "serve_batch":
            return self._serve_batch(req)
        if cmd == "serve_stats":
            return self._serve_stats()
        if cmd == "plan_stage":
            return self._plan_stage(req)
        return self._fetch(req, files)

    def _fetch(self, req: dict, files: dict | None):
        """Stream back one bounded window of an intermediate this worker
        produced; the master pipelines ``offset`` windows until ``eof``.
        Containment boundary = ``self.workdir`` (server config, not the
        request)."""
        path = req.get("path", "")
        real = os.path.realpath(path)
        if not real.startswith(self.workdir + os.sep):
            return {"status": "error", "error": "path outside workdir"}
        try:
            offset = int(req.get("offset", 0))
            max_bytes = int(req.get("max_bytes", protocol.FETCH_CHUNK))
        except (TypeError, ValueError):
            return {"status": "error", "error": "bad offset/max_bytes"}
        if offset < 0:
            return {"status": "error", "error": "negative offset"}
        max_bytes = max(1, min(max_bytes, protocol.FETCH_CHUNK_MAX))
        try:
            data, size = self._read_window(real, offset, max_bytes, files)
        except OSError as e:
            return {"status": "error", "error": str(e)}
        # eof/total reflect the REAL read (pre-fault): an injected disk-rot
        # corruption or truncation must look like a worker that believes
        # it delivered the bytes; the master's sha256 check catches it.
        eof = offset + len(data) >= size
        data = faultplan.mangle(
            "io.intermediate", data,
            path=real, offset=offset, port=self.addr[1],
        )
        # Per-chunk digest over the RAW window: covers the wire encoding
        # round trip (base64 or zlib) up to the master's disk write.
        meta = {
            "status": "ok",
            "sha256": hashlib.sha256(data).hexdigest(),
            "offset": offset,
            "total": size,
            "eof": eof,
        }
        tctx = req.get(protocol.TRACE_KEY)
        if isinstance(tctx, dict) and tctx.get("id"):
            # Correlation echo: every fetched chunk is attributable to
            # the job's trace_id.
            meta["trace_id"] = str(tctx["id"])
        if not (req.get("bin") and self.support_binary):
            # Pre-binary master (or a worker pinned JSON-only): the base64
            # JSON reply.
            return dict(meta, data_b64=base64.b64encode(data).decode())
        # Binary data plane: raw payload, zlib'd when the master accepts
        # it and it actually shrinks the chunk.
        flags, body, enc = 0, data, "raw"
        if req.get("accept_zlib") and data:
            packed = zlib.compress(data, 1)
            if len(packed) < len(data):
                flags, body, enc = protocol.FLAG_ZLIB, packed, "zlib"
        # Chaos: the ENCODED payload about to be framed.  The frame MAC is
        # computed after this, so an injected corruption reaches the master
        # as a zlib error or a chunk-sha mismatch, not an HMAC reject.
        rule = faultplan.fire(
            "io.chunk", path=real, offset=offset, port=self.addr[1], enc=enc
        )
        if rule is not None:
            if rule.action == "delay":
                time.sleep(rule.delay_s)
            else:
                body = faultplan.active().mutate(rule, body)
        return dict(meta, enc=enc, clen=len(body)), body, flags

    def _traced_map(self, req: dict) -> dict:
        """Run one map command under a REQUEST-scoped tracer when the
        master stamped a trace context into the request.  The worker's
        spans travel back in the reply ("spans", with the worker's wall
        clock as "clock" for the master's offset estimate) and never leak
        into a tracer enabled in this process (``obs.scoped``).  An error
        reply ships its spans too; an injected crash drops them with the
        connection, as a real SIGKILL would."""
        tctx = req.get(protocol.TRACE_KEY)
        tracer = None
        if isinstance(tctx, dict) and tctx.get("id"):
            tracer = obs.Tracer(
                trace_id=str(tctx["id"]),
                process=f"worker:{self.addr[1]}",
            )
        with obs.scoped(tracer):
            with obs.span(
                "worker.map",
                shard=req.get("node_num"),
                port=self.addr[1],
            ):
                resp = self._run_map(req)
        if tracer is not None and isinstance(resp, dict):
            resp["spans"] = tracer.serialize()
            resp["clock"] = time.time()
        return resp

    def _run_map(self, req: dict) -> dict:
        rule = faultplan.fire(
            "worker.map", shard=req.get("node_num"), port=self.addr[1]
        )
        if rule is not None:
            if rule.action == "crash":
                raise faultplan.FaultCrash("injected crash mid-map")
            if rule.action == "error":
                return {"status": "error", "returncode": -9,
                        "log": "[faultplan] injected map failure",
                        "error": "injected map failure"}
            if rule.action == "delay":
                time.sleep(rule.delay_s)
        try:
            with self._map_lock:  # one card: maps serialize
                resp = self.map_runner(req)
        except Exception as e:  # propagate failure, don't fake-ACK
            return {"status": "error", "error": repr(e)}
        if resp.get("status") == "ok" and "sha256" not in resp:
            # End-to-end integrity anchor: the intermediate's digest at map
            # time, which the master checks the assembled fetch against.  A
            # runner that wrote no file ships no digest.
            inter = resp.get("intermediate") or req.get("intermediate")
            try:
                resp["sha256"] = _file_sha256(inter)
            except (OSError, TypeError):
                pass
        return resp

    # ------------------------------------------------- serve-batch surface

    def _serve_stats(self) -> dict:
        """The pool's warm-cache RPC (serve/pool.py seed_affinity): which
        shapes this worker already holds compiled.  A daemon restarting
        against a warm fleet re-learns affinity homes from this instead
        of cold-spraying its first batches."""
        if self._serve_cache is None:
            return dict(_SERVE_DISABLED)
        return {
            "status": "ok",
            "exec_cache": self._serve_cache.stats(),
            "warm_shapes": self._serve_cache.warm_shapes(),
        }

    def _serve_batch(self, req: dict) -> dict:
        """Fold one coalesced serve batch on this worker's engine.

        The daemon's pool (serve/pool.py) sends the batch meta plus
        content-addressed corpus REFERENCES — ``spill_dir/<sha>.bin``
        files the journal/pool already wrote once — and this handler
        verifies every sha before folding, so a stale, torn, or
        misdirected spill is a structured error, never a silent wrong
        answer.  Shard entries carry ``line_start``/``line_end`` (the
        same half-open line-range contract as the map command) and fold
        just that slice.  Dispatches serialize under ``_map_lock`` (one
        card per node, same stance as map)."""
        if self._serve_cache is None:
            return dict(_SERVE_DISABLED)
        if protocol.EPOCH_KEY in req:
            try:
                stale = self._epoch_guard.observe(req[protocol.EPOCH_KEY])
            except (TypeError, ValueError):
                return {"status": "error",
                        "error": f"bad fencing epoch "
                                 f"{req[protocol.EPOCH_KEY]!r}"}
            if stale is not None:
                # The zombie-primary fence: this worker has already
                # served a newer primary — obeying the old one would be
                # the split-brain double-answer HA forbids.  The ONE
                # fencing-reply shape (serve/replicate.py): the reply
                # carries the high-water epoch so the fenced daemon
                # adopts the REAL fence instead of guessing.
                from locust_tpu_torch.serve.replicate import stale_reply

                return stale_reply(stale, None)
        from locust_tpu_torch.config import EngineConfig
        from locust_tpu_torch.serve import batch as batching
        from locust_tpu_torch.serve.jobs import (
            SPEC_CONFIG_KEYS,
            WORKLOADS,
            Job,
            JobSpec,
        )

        workload = req.get("workload")
        if workload not in WORKLOADS:
            return {"status": "error",
                    "error": f"unknown workload {workload!r}"}
        overrides = req.get("config") or {}
        if not isinstance(overrides, dict) or (
            set(overrides) - set(SPEC_CONFIG_KEYS)
        ):
            return {"status": "error",
                    "error": f"bad config overrides {overrides!r}"}
        try:
            cfg = EngineConfig(**overrides)
            bucket = int(req["bucket"])
            spill_dir = str(req["spill_dir"])
            jobs_meta = list(req["jobs"])
        except (KeyError, TypeError, ValueError) as e:
            return {"status": "error", "error": f"bad serve_batch: {e}"}
        if not jobs_meta:
            return {"status": "error", "error": "serve_batch with no jobs"}
        spec = JobSpec(tenant="pool", workload=workload, cfg=cfg)
        corpora: dict[str, list] = {}
        jobs: list[Job] = []
        for jm in jobs_meta:
            try:
                sha = str(jm["sha"])
                job_id = str(jm["job_id"])
                a = jm.get("line_start")
                b = jm.get("line_end")
            except (KeyError, TypeError):
                return {"status": "error", "error": f"bad job entry {jm!r}"}
            try:
                lines = self._serve_corpus_lines(sha, spill_dir)
            except ValueError as e:
                return {"status": "error", "error": str(e)}
            if a is not None or b is not None:
                lines = lines[int(a or 0):
                              int(b) if b is not None else len(lines)]
            # Each (sha, slice) is its own staging key: two shards of one
            # corpus must not alias each other's lines.
            ckey = f"{sha}:{a}:{b}"
            n_lines = len(lines)
            n_blocks, jbucket = batching.job_shape(n_lines, cfg)
            if jbucket > bucket:
                return {"status": "error",
                        "error": f"job {job_id}: {n_lines} lines need "
                                 f"bucket {jbucket} > batch bucket {bucket}"}
            corpora[ckey] = lines
            jobs.append(Job(
                job_id=job_id, spec=spec, corpus_digest=ckey,
                n_lines=n_lines, n_blocks=n_blocks, bucket=bucket,
            ))
        njobs_padded = batching.bucket_blocks(len(jobs))
        try:
            with self._map_lock:  # one card: folds serialize
                engine, hit = self._serve_cache.lookup(
                    spec, njobs_padded, bucket
                )
                results = batching.dispatch_batch(engine, jobs, corpora)
                self._serve_cache.mark_compiled(spec, njobs_padded, bucket)
                out = []
                for job, res in zip(jobs, results):
                    pairs = res.to_host_pairs()
                    out.append({
                        "job_id": job.job_id,
                        "pairs": [
                            [base64.b64encode(k).decode(), int(v)]
                            for k, v in pairs
                        ],
                        "distinct": int(res.num_segments),
                        "truncated": bool(res.truncated),
                        "overflow_tokens": int(res.overflow_tokens),
                    })
        except Exception as e:  # noqa: BLE001 - structured, worker survives
            return {"status": "error",
                    "error": f"serve dispatch failed: "
                             f"{type(e).__name__}: {e}"}
        return {"status": "ok", "warm": bool(hit), "results": out}

    # ------------------------------------------------ plan-stage surface

    def _plan_stage(self, req: dict) -> dict:
        """One distributed-plan stage on this worker (docs/PLAN.md
        "Distributed execution"): phase "map" folds one source split and
        publishes its shuffle partitions atomically into the spill dir;
        phase "reduce" pulls one partition's inputs from their map
        workers over the binary data plane and returns the combined
        table.  Epoch-fenced like serve_batch: a fenced-out zombie
        primary can never get a stale partition published."""
        if self._serve_cache is None:
            return dict(_SERVE_DISABLED)
        if protocol.EPOCH_KEY in req:
            try:
                stale = self._epoch_guard.observe(req[protocol.EPOCH_KEY])
            except (TypeError, ValueError):
                return {"status": "error",
                        "error": f"bad fencing epoch "
                                 f"{req[protocol.EPOCH_KEY]!r}"}
            if stale is not None:
                from locust_tpu_torch.serve.replicate import stale_reply

                return stale_reply(stale, None)
        phase = req.get("phase")
        # Chaos: the stage RPC boundary (docs/FAULTS.md).  "crash" models
        # the worker SIGKILL'd mid-stage (connection dropped, no reply —
        # the coordinator recomputes the stage on a survivor); "error" a
        # structured stage failure; "delay" a straggler the coordinator's
        # speculative backup races.
        rule = faultplan.fire(
            "plan.stage", phase=phase, split=req.get("split"),
            part=req.get("part"), port=self.addr[1],
        )
        if rule is not None:
            if rule.action == "crash":
                raise faultplan.FaultCrash("injected crash mid-plan-stage")
            if rule.action == "error":
                return {"status": "error",
                        "error": "[faultplan] injected plan stage failure"}
            if rule.action == "delay":
                time.sleep(rule.delay_s)
        try:
            with obs.span(
                "plan.stage", phase=phase, split=req.get("split"),
                part=req.get("part"), port=self.addr[1],
            ):
                if phase == "map":
                    return self._plan_map_stage(req)
                if phase == "reduce":
                    return self._plan_reduce_stage(req)
                if phase == "join":
                    return self._plan_join_stage(req)
                if phase == "iterate":
                    return self._plan_iterate_stage(req)
                return {"status": "error",
                        "error": f"unknown plan stage phase {phase!r}"}
        except Exception as e:  # noqa: BLE001 - structured, worker survives
            return {"status": "error",
                    "error": f"plan stage failed: {type(e).__name__}: {e}"}

    def _plan_map_stage(self, req: dict) -> dict:
        """Fold one source split and publish its shuffle partitions.

        The split's lines come from the content-addressed corpus spill
        (sha-verified, like serve_batch); doc ids are GLOBAL
        (``(line_start + i) // lines_per_doc``) so the per-split fold is
        exactly a restriction of the solo fold.  Partition files publish
        atomically under (plan fp, split, partition, attempt) — a
        recompute or speculative backup can never clobber a live file.
        """
        import numpy as np

        from locust_tpu_torch.config import EngineConfig
        from locust_tpu_torch.plan import distribute
        from locust_tpu_torch.serve import batch as batching
        from locust_tpu_torch.serve.jobs import SPEC_CONFIG_KEYS, Job, JobSpec

        overrides = req.get("config") or {}
        if not isinstance(overrides, dict) or (
            set(overrides) - set(SPEC_CONFIG_KEYS)
        ):
            return {"status": "error",
                    "error": f"bad config overrides {overrides!r}"}
        try:
            cfg = EngineConfig(**overrides)
            fold = str(req["fold"])
            sha = str(req["sha"])
            spill_dir = str(req["spill_dir"])
            plan_fp = str(req["plan_fp"])
            split = int(req["split"])
            attempt = int(req["attempt"])
            n_parts = int(req["n_parts"])
            a = int(req["line_start"])
            b = int(req["line_end"])
            lines_per_doc = int(req.get("lines_per_doc", 1))
        except (KeyError, TypeError, ValueError) as e:
            return {"status": "error", "error": f"bad plan_stage: {e}"}
        try:
            lines = self._serve_corpus_lines(sha, spill_dir)
        except ValueError as e:
            return {"status": "error", "error": str(e)}
        sl = lines[a:b]
        truncated, overflow = False, 0
        warm = False
        if fold == "wordcount":
            spec = JobSpec(tenant="pool", workload="wordcount", cfg=cfg)
            n_blocks, bucket = batching.job_shape(len(sl), cfg)
            ckey = f"{sha}:{a}:{b}"
            node_fp = str(req.get("node_fp") or "")
            job = Job(
                job_id=f"plan-{plan_fp}-s{split}", spec=spec,
                corpus_digest=ckey, n_lines=len(sl), n_blocks=n_blocks,
                bucket=bucket,
            )
            with self._map_lock:  # one card: folds serialize
                if node_fp:
                    # Warm by the fold node's CLOSURE fingerprint
                    # (cache.fold_node_key): a repeat distributed plan
                    # — alpha-renamed included — lands every map split
                    # on this worker's already-compiled executable, so
                    # ``compiles`` stays flat on resubmit (the warm
                    # accounting whole serve jobs get).
                    engine, warm = self._serve_cache.lookup_fold_node(
                        node_fp, cfg, 1, bucket
                    )
                else:
                    engine, warm = self._serve_cache.lookup(
                        spec, 1, bucket
                    )
                res = batching.dispatch_batch(
                    engine, [job], {ckey: sl}
                )[0]
                if node_fp:
                    self._serve_cache.mark_compiled_fold_node(
                        node_fp, cfg.fingerprint(), 1, bucket
                    )
                else:
                    self._serve_cache.mark_compiled(spec, 1, bucket)
                pairs = res.to_host_pairs()
                truncated = bool(res.truncated)
                overflow = int(res.overflow_tokens)
            enc = pairs
        elif fold in ("tf", "index"):
            from locust_tpu_torch.apps.tfidf import term_doc_counts

            ids = ((a + np.arange(len(sl))) // lines_per_doc).astype(
                np.int32
            )
            with self._map_lock:
                # The index fold tolerates per-line emit overflow the
                # way build_inverted_index does (warn, drop) — the solo
                # path's exact semantics; tf raises, also solo-exact.
                tf = term_doc_counts(
                    sl, ids, cfg, allow_overflow=(fold == "index"),
                    device=self.device,
                )
            enc = [
                (distribute.encode_key(fold, k), v)
                for k, v in tf.items()
            ]
        else:
            return {"status": "error", "error": f"unknown fold {fold!r}"}
        parts = distribute.publish_split(
            spill_dir, plan_fp, split, attempt, enc, n_parts
        )
        return {
            "status": "ok",
            "split": split,
            "attempt": attempt,
            "worker": f"{self.addr[0]}:{self.addr[1]}",
            "parts": parts,
            "truncated": truncated,
            "overflow_tokens": overflow,
            "warm": bool(warm),
        }

    def _plan_reduce_stage(self, req: dict) -> dict:
        """Combine one shuffle partition from its per-split input files.

        Inputs published by OTHER workers move worker-to-worker over the
        distributor's binary HMAC'd data plane (master.fetch_file:
        pipelined windows, sha-verified end to end) — the daemon never
        relays partition bytes.  ANY lost/damaged input answers a
        structured error naming ``lost_split`` so the coordinator
        recomputes exactly that map split from its durable corpus split,
        not the whole plan."""
        try:
            part = int(req["part"])
            key_width = int(req["key_width"])
            inputs = list(req["inputs"])
        except (KeyError, TypeError, ValueError) as e:
            return {"status": "error", "error": f"bad plan_stage: {e}"}
        me = f"{self.addr[0]}:{self.addr[1]}"
        acc, err = self._merge_partition_inputs(inputs, key_width, part)
        if err is not None:
            return err
        return {
            "status": "ok",
            "part": part,
            "worker": me,
            "pairs": [
                [base64.b64encode(k).decode(), int(v)]
                for k, v in sorted(acc.items())
            ],
        }

    def _merge_partition_inputs(
        self, inputs: list, key_width: int, part: int
    ) -> tuple[dict | None, dict | None]:
        """The reduce/join stages' shared input gather: read (local) or
        pull (remote) every per-split partition file for one bin and
        sum-merge.  Returns (table, None) or (None, structured error
        reply naming ``lost_split``)."""
        from locust_tpu_torch.plan import distribute

        me = f"{self.addr[0]}:{self.addr[1]}"
        acc: dict = {}
        for ref in inputs:
            try:
                path = str(ref["path"])
                sha = str(ref["sha256"])
                owner = str(ref["worker"])
                split = int(ref["split"])
            except (KeyError, TypeError, ValueError):
                return None, {"status": "error",
                              "error": f"bad partition ref {ref!r}"}
            if int(ref.get("pairs", 1)) == 0:
                continue  # published empty: nothing to move or merge
            try:
                if owner == me:
                    pairs = distribute.read_partition(path, sha, key_width)
                else:
                    pairs = self._pull_partition(
                        owner, path, sha, key_width, part
                    )
            except Exception as e:  # noqa: BLE001 - structured loss report
                return None, {
                    "status": "error",
                    "lost_split": split,
                    "error": f"partition input lost (split {split}, "
                             f"part {part}, {owner}): "
                             f"{type(e).__name__}: {e}",
                }
            distribute.merge_pairs(acc, pairs)
        return acc, None

    def _plan_join_stage(self, req: dict) -> dict:
        """Evaluate one co-partitioned hash-join bin, tree-deep.

        The bin's wordcount table merges from its per-split partition
        inputs exactly like a reduce stage; then the WHOLE join tree
        evaluates over it locally (``distribute.eval_tree_doc`` — host
        Python ints, the solo ``_eval_join`` semantics) — however deep
        the tree, the bin never returns to the master between joins
        (docs/PLAN.md "Distributed execution").  ``distinct`` reports
        the bin's pre-join table size so the coordinator can prove the
        solo fold would not have truncated (its capacity gate)."""
        from locust_tpu_torch.plan import distribute

        try:
            part = int(req["part"])
            key_width = int(req["key_width"])
            inputs = list(req["inputs"])
            tree = list(req["tree"])
        except (KeyError, TypeError, ValueError) as e:
            return {"status": "error", "error": f"bad plan_stage: {e}"}
        me = f"{self.addr[0]}:{self.addr[1]}"
        acc, err = self._merge_partition_inputs(inputs, key_width, part)
        if err is not None:
            return err
        try:
            joined = distribute.eval_tree_doc(tree, acc)
        except (KeyError, IndexError, TypeError, ValueError) as e:
            return {"status": "error",
                    "error": f"bad join tree {tree!r}: {e}"}
        return {
            "status": "ok",
            "part": part,
            "worker": me,
            "distinct": len(acc),
            "pairs": [
                [base64.b64encode(k).decode(), int(v)]
                for k, v in sorted(joined.items())
            ],
        }

    def _plan_iterate_stage(self, req: dict) -> dict:
        """One pagerank epoch on one rank shard (docs/PLAN.md
        "Distributed execution").

        The worker holds the loop-invariant graph state (edge arrays,
        inv_deg, dangling mask — cached per corpus sha, shard-filtered
        to ``dst in [lo, hi)``), reconstructs the previous epoch's full
        rank vector from ALL shards' published partitions (shard order
        is node order), runs ONE bit-exact ``pagerank_step`` and
        publishes its own slice for the next epoch.  Epoch 1 starts
        from the solo path's exact ``ranks0``.  A lost input partition
        answers structured ``(lost_epoch, lost_split)`` so the
        coordinator recomputes exactly that (epoch, shard) stage."""
        import numpy as np

        from locust_tpu_torch.plan import distribute

        try:
            sha = str(req["sha"])
            spill_dir = str(req["spill_dir"])
            plan_fp = str(req["plan_fp"])
            epoch = int(req["epoch"])       # 1-based sweep number
            shard = int(req["shard"])
            n_shards = int(req["n_shards"])
            num_nodes = int(req["num_nodes"])
            damping = float(req["damping"])
            attempt = int(req["attempt"])
            inputs = req.get("inputs")      # None on epoch 1
        except (KeyError, TypeError, ValueError) as e:
            return {"status": "error", "error": f"bad plan_stage: {e}"}
        try:
            src_sub, dst_sub, inv_deg, dangling, grouping = self._iterate_graph(
                sha, spill_dir, num_nodes, shard, n_shards
            )
        except ValueError as e:
            return {"status": "error", "error": str(e)}
        me = f"{self.addr[0]}:{self.addr[1]}"
        if inputs is None:
            # The solo path's exact ranks0: 1/n rounded double->f32.
            ranks = np.full(
                (num_nodes,), 1.0 / num_nodes, dtype=np.float32
            )
        else:
            slices = []
            for ref in sorted(inputs, key=lambda r: int(r["part"])):
                try:
                    path = str(ref["path"])
                    rsha = str(ref["sha256"])
                    owner = str(ref["worker"])
                    part = int(ref["part"])
                except (KeyError, TypeError, ValueError):
                    return {"status": "error",
                            "error": f"bad partition ref {ref!r}"}
                try:
                    if owner == me or os.path.exists(path):
                        pairs = distribute.read_partition(
                            path, rsha, distribute.RANK_KEY_WIDTH
                        )
                    else:
                        pairs = self._pull_partition(
                            owner, path, rsha,
                            distribute.RANK_KEY_WIDTH, part,
                        )
                except Exception as e:  # noqa: BLE001 - structured loss
                    return {
                        "status": "error",
                        "lost_split": part,
                        "lost_epoch": epoch - 1,
                        "error": f"rank partition lost (epoch "
                                 f"{epoch - 1}, shard {part}, {owner}): "
                                 f"{type(e).__name__}: {e}",
                    }
                slices.append(distribute.decode_rank_values(pairs))
            ranks = np.concatenate(slices) if slices else np.zeros(
                0, np.float32
            )
            if len(ranks) != num_nodes:
                return {"status": "error",
                        "error": f"rank vector reassembled {len(ranks)} "
                                 f"of {num_nodes} nodes"}
        import torch

        from locust_tpu_torch.apps.pagerank import pagerank_step

        lo, hi = distribute.shard_ranges(num_nodes, n_shards)[shard]
        with self._map_lock:  # one card: device steps serialize
            new = pagerank_step(  # locust: noqa[R003] one read per plan_stage request, not per block: the stage's ranks go back over the wire as numpy
                src_sub, dst_sub,
                torch.from_numpy(ranks).to(self.device), inv_deg, dangling,
                damping, num_nodes, grouping,
            ).cpu().numpy()
        ref = distribute.publish_partition(
            distribute.partition_path(
                spill_dir, plan_fp, epoch, shard, attempt
            ),
            distribute.encode_rank_pairs(lo, new[lo:hi]),
        )
        ref["part"] = shard
        return {
            "status": "ok",
            "epoch": epoch,
            "shard": shard,
            "attempt": attempt,
            "worker": me,
            "ref": ref,
        }

    def _iterate_graph(
        self, sha: str, spill_dir: str, num_nodes: int, shard: int,
        n_shards: int,
    ) -> tuple:
        """The iterate stages' loop-invariant state, cached per (corpus
        sha, num_nodes, shard layout): parsed edge arrays restricted to
        this shard's dst range plus the FULL inv_deg/dangling vectors
        (``pagerank_prep``, bit-exact vs the solo path's prologue) and
        the subset's in-edge grouping (``pagerank_grouping``), all on the
        serve device.
        Raises ``ValueError`` on a missing/damaged spill or a corpus
        that does not parse as an edge list."""
        import numpy as np
        import torch

        from locust_tpu_torch.plan import distribute

        key = (sha, int(num_nodes), int(n_shards), int(shard))
        with self._iterate_lock:
            ent = self._iterate_graphs.pop(key, None)
            if ent is not None:
                self._iterate_graphs[key] = ent  # LRU touch
                return ent
        path = os.path.join(spill_dir, f"{sha}.bin")
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise ValueError(f"corpus spill unreadable: {e}")
        if hashlib.sha256(data).hexdigest() != sha:
            raise ValueError(f"corpus spill {sha} fails its content hash")
        from locust_tpu_torch.apps.pagerank import pagerank_grouping, pagerank_prep
        from locust_tpu_torch.plan.compile import PlanError, edges_from_bytes

        try:
            src, dst = edges_from_bytes(data)
        except PlanError as e:
            raise ValueError(f"corpus is not an edge list: {e}")
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        with self._map_lock:
            inv_deg, dangling = pagerank_prep(src, num_nodes, self.device)
        lo, hi = distribute.shard_ranges(num_nodes, n_shards)[shard]
        mask = (dst >= lo) & (dst < hi)
        src_t = torch.from_numpy(src[mask]).to(self.device)
        dst_t = torch.from_numpy(dst[mask]).to(self.device)
        with self._map_lock:
            grouping = pagerank_grouping(src_t, dst_t, num_nodes, self.device)
        ent = (src_t, dst_t, inv_deg, dangling, grouping)
        with self._iterate_lock:
            self._iterate_graphs[key] = ent
            while len(self._iterate_graphs) > 4:
                self._iterate_graphs.pop(next(iter(self._iterate_graphs)))
        return ent

    def _pull_partition(
        self, owner: str, path: str, sha: str, key_width: int, part: int
    ) -> list:
        """Fetch one remote partition over the binary data plane and
        decode it.  The transfer verifies the file sha end-to-end
        (fetch_file's expect_sha) and the local decode re-verifies —
        a mangled wire or disk byte is a loss, never a wrong answer."""
        from locust_tpu_torch.distributor import master
        from locust_tpu_torch.plan import distribute

        host, _, port = owner.rpartition(":")
        local = os.path.join(
            self.workdir,
            f"pull_{os.path.basename(path)}.{os.getpid()}."
            f"{threading.get_ident()}",
        )
        with obs.span("plan.shuffle", part=part, src=owner):
            try:
                master.fetch_file(
                    (host, int(port)), path, local, self.secret,
                    expect_sha=sha, rpc_timeout=120.0,
                )
                return distribute.read_partition(local, sha, key_width)
            finally:
                try:
                    os.unlink(local)
                except OSError:
                    pass

    def _serve_corpus_lines(self, sha: str, spill_dir: str) -> list:
        """One spilled corpus read+verified+split, through the tiny LRU
        cache.  Raises ``ValueError`` with the structured message on a
        missing/damaged spill — a stale or torn spill must never fold."""
        with self._serve_corpus_lock:
            ent = self._serve_corpus.pop(sha, None)
            if ent is not None:
                self._serve_corpus[sha] = ent  # LRU touch
                return ent
        path = os.path.join(spill_dir, f"{sha}.bin")
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise ValueError(f"corpus spill unreadable: {e}")
        if hashlib.sha256(data).hexdigest() != sha:
            raise ValueError(f"corpus spill {sha} fails its content hash")
        lines = data.splitlines()
        with self._serve_corpus_lock:
            self._serve_corpus[sha] = lines
            while len(self._serve_corpus) > 2:
                self._serve_corpus.pop(next(iter(self._serve_corpus)))
        return lines

    def _read_window(
        self, real: str, offset: int, max_bytes: int, files: dict | None
    ) -> tuple[bytes, int]:
        """One bounded window, through the per-connection handle cache."""
        if files is None:  # direct _handle call (unit tests): no cache
            with open(real, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                f.seek(offset)
                return f.read(max_bytes), size
        ent = files.get(real)
        if ent is None:
            while len(files) >= self.MAX_CACHED_FILES:
                _, (old, _) = files.popitem()
                try:
                    old.close()
                except OSError:
                    pass
            fh = open(real, "rb")
            ent = files[real] = (fh, os.fstat(fh.fileno()).st_size)
        fh, size = ent
        fh.seek(offset)
        return fh.read(max_bytes), size


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="locust-torch-worker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1337)  # reference port, slave.py:7
    p.add_argument("--secret-env", default="LOCUST_SECRET",
                   help="env var holding the shared secret")
    p.add_argument("--fault-plan", default=None,
                   help="fault injection plan: JSON text or a path "
                        f"(also ${faultplan.ENV_VAR})")
    p.add_argument("--workdir", default=None,
                   help="fetch containment boundary (server-side config; "
                        "default the temporary directory)")
    p.add_argument("--serve", action="store_true",
                   help="answer serve_batch dispatches from a serve "
                        "daemon's worker pool (docs/SERVING.md "
                        "scale-out dispatch); holds warm engines")
    p.add_argument("--serve-max-engines", type=int, default=4,
                   help="warm engines kept by the serve cache (LRU)")
    p.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                   help="the serve engines' device: cuda (default; the "
                        "kernels are built at start) or cpu (their plain "
                        "versions)")
    args = p.parse_args(argv)
    faultplan.install(args.fault_plan)
    secret = os.environ.get(args.secret_env, "").encode()
    if not secret:
        print(f"error: set ${args.secret_env} (refusing unauthenticated mode)",
              file=sys.stderr)
        return 2
    try:
        w = Worker(args.host, args.port, secret, workdir=args.workdir,
                   serve=args.serve, serve_max_engines=args.serve_max_engines,
                   device=args.backend)
    except (RuntimeError, OSError) as e:
        # No card, a failed kernel build or a port in use: an operator
        # one-liner, and never a worker that serves from the CPU.
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"[worker] listening on {w.addr[0]}:{w.addr[1]}", file=sys.stderr, flush=True)
    w.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
