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

The serve surface (``serve_batch``, ``serve_stats``, ``plan_stage``)
waits for the serve slice 10 (ROADMAP.md queue 1 item 8: the worker
pool, the worker's serve surface, plan/distribute.py and high
availability; the single-node daemon is ``locust_tpu_torch.serve``): the
commands are answered with the JAX worker's structured error for a worker started
without ``--serve``, and ``Worker(serve=True)`` refuses at construction.

Fault sites (utils/faultplan.py): ``rpc.delay`` before a command is
handled, ``worker.map`` before a map runs, ``io.intermediate`` on a raw
fetch window and ``io.chunk`` on the encoded payload of a binary reply.
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
    ):
        if not secret:
            raise ValueError("worker requires a shared secret (Q8: no open RCE)")
        if serve:
            raise NotImplementedError(
                "the worker's serve surface (serve_batch, serve_stats, plan_stage) "
                "is not ported yet: ROADMAP.md queue 1 item 8, the serve slice 10 "
                "(the worker pool, distributed plans and high availability)"
            )
        self.secret = secret
        self.map_runner = map_runner
        # support_binary=False emulates a pre-binary (JSON-only) peer:
        # negotiation requests are ignored and every reply is a JSON frame.
        self.support_binary = support_binary
        # Fetch containment boundary is WORKER-side configuration; a request
        # must not be able to choose its own boundary.  The default is the
        # temporary directory, where the master's intermediates land.
        self.workdir = os.path.realpath(workdir or tempfile.gettempdir())
        self.conn_timeout = conn_timeout
        self._replay_guard = protocol.ReplayGuard()
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
        if cmd in ("serve_batch", "serve_stats", "plan_stage"):
            return dict(_SERVE_DISABLED)
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
                   help="answer serve_batch dispatches (not ported yet: refused)")
    p.add_argument("--serve-max-engines", type=int, default=4,
                   help="warm engines kept by the serve cache (with --serve)")
    args = p.parse_args(argv)
    faultplan.install(args.fault_plan)
    secret = os.environ.get(args.secret_env, "").encode()
    if not secret:
        print(f"error: set ${args.secret_env} (refusing unauthenticated mode)",
              file=sys.stderr)
        return 2
    try:
        w = Worker(args.host, args.port, secret, workdir=args.workdir,
                   serve=args.serve, serve_max_engines=args.serve_max_engines)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"[worker] listening on {w.addr[0]}:{w.addr[1]}", file=sys.stderr, flush=True)
    w.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
