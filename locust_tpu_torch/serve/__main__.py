"""CLI surface for the port's serve tier (the JAX ``serve/__main__.py``'s
commands, flags and output).

    python -m locust_tpu_torch.serve [--host H] [--port P] [--secret-env VAR]
        [--max-queue N] [--max-batch N] [--tenant-quota N] [--warm-dir DIR]
        [--journal-dir DIR] [--backend cuda|cpu]
        [--workers H:P,H:P] [--shard-min-blocks N]
        [--ship-to H:P | --standby-of H:P [--lease S]]
        [--fault-plan PLAN] [--trace-out FILE]        # run the daemon
        # --workers: scale-out dispatch across serve-capable distributor
        # workers (each started with --serve); docs/SERVING.md

    python -m locust_tpu_torch.serve submit FILE [--tenant T] [--weight W]
        [--block-lines N] [--sort-mode M] [--no-wait] ...   # one job
    python -m locust_tpu_torch.serve submit FILE --plan PLAN.json  # a plan job
    python -m locust_tpu_torch.serve result JOB_ID [--wait]  # fetch by id
    python -m locust_tpu_torch.serve status|cancel JOB_ID    # one job's record
    python -m locust_tpu_torch.serve invalidate [--job-id J] [--digest D]
        [--spec-fp F]                                  # drop cached results
    python -m locust_tpu_torch.serve stats                   # daemon stats
    python -m locust_tpu_torch.serve shutdown                # stop it
    python -m locust_tpu_torch.serve promote [--port P]      # standby -> primary

The daemon runs its engines on the card (``--backend cuda``, the
default; it builds the kernels at start and exits 2 without a card) or,
with ``--backend cpu``, on the plain versions of the kernels.
``--workers`` places batches on a pool of ``python -m
locust_tpu_torch.distributor.worker --serve`` processes (or JAX ones),
sharding jobs of ``--shard-min-blocks`` blocks or more and distributing
covered plans; ``--ship-to`` ships the journal to a hot standby started
with ``--standby-of``, which takes over on ``promote`` or after
``--lease`` seconds without its primary (docs/SERVING.md "High
availability").  Client commands take ``--daemon H:P,H:P``, an HA roster
that follows ``not_primary`` redirects.

A structured daemon rejection (``ServeError``) prints as
``error: [code] message`` and exits 1 — the code is the machine-readable
part (``queue_full`` -> back off, ``not_done`` -> poll again, ...).

The daemon refuses to start without a shared secret (same Q8 stance as
the distributor worker); clients read the same env var.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from locust_tpu_torch.utils import faultplan

_CLIENT_CMDS = ("submit", "result", "status", "cancel", "invalidate",
                "stats", "shutdown", "promote")


def _secret(args) -> bytes:
    secret = os.environ.get(args.secret_env, "").encode()
    if not secret:
        print(f"error: set ${args.secret_env} (refusing unauthenticated "
              "mode)", file=sys.stderr)
        raise SystemExit(2)
    return secret


def _daemon_main(argv) -> int:
    p = argparse.ArgumentParser(prog="locust-serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1347)
    p.add_argument("--secret-env", default="LOCUST_SECRET")
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--tenant-quota", type=int, default=32,
                   help="pending jobs per tenant (0 = unlimited)")
    p.add_argument("--warm-dir", default=None,
                   help="persist the result cache across restarts here "
                        "(async snapshot writer, docs/SERVING.md)")
    p.add_argument("--journal-dir", default=None,
                   help="write-ahead job journal: accepted jobs survive "
                        "kill -9 and replay on restart (docs/SERVING.md "
                        "durability)")
    p.add_argument("--fault-plan", default=None,
                   help="chaos-test fault plan: JSON text or a path "
                        f"(also ${faultplan.ENV_VAR}); see docs/FAULTS.md")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="export the daemon's serve.* telemetry as "
                        "Chrome-trace JSON at exit (docs/OBSERVABILITY.md)")
    p.add_argument("--workers", default=None, metavar="H:P,H:P",
                   help="scale-out dispatch: comma-separated host:port "
                        "roster of serve-capable distributor workers "
                        "(python -m locust_tpu_torch.distributor.worker "
                        "--serve); batches place across them with "
                        "cache affinity, the local engine stays the "
                        "floor (docs/SERVING.md)")
    p.add_argument("--shard-min-blocks", type=int, default=64,
                   help="blocks at which a large job fans out across "
                        "the worker pool (with --workers)")
    p.add_argument("--ship-to", default=None, metavar="H:P",
                   help="high availability (docs/SERVING.md): ship every "
                        "fsync'd WAL record to the hot-standby daemon at "
                        "this address (requires --journal-dir; shipping "
                        "is async — a dead standby never slows admits)")
    p.add_argument("--standby-of", default=None, metavar="H:P",
                   help="start as a HOT STANDBY of the primary at this "
                        "address (requires --journal-dir): apply shipped "
                        "WAL records, answer stats/ping, refuse the job "
                        "plane with not_primary until promoted "
                        "(`... promote` or --lease expiry)")
    p.add_argument("--lease", type=float, default=None, metavar="S",
                   help="standby auto-promotion: take over after S "
                        "seconds without primary contact (default: "
                        "manual `promote` only)")
    p.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                   help="the engines' device: cuda (default; the kernels "
                        "are built at start) or cpu (their plain versions)")
    args = p.parse_args(argv)
    faultplan.install(args.fault_plan)
    from locust_tpu_torch import obs

    if args.trace_out:
        obs.enable(process="serve")
    try:
        daemon = _build_daemon(args)
    except (ValueError, RuntimeError, OSError) as e:
        # A config refusal (e.g. --ship-to without --journal-dir), no
        # card, a failed kernel build or a port in use is an
        # operator one-liner, not a traceback.
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"[serve] listening on {daemon.addr[0]}:{daemon.addr[1]}"
          + (f" (role {daemon.role})" if (args.standby_of or args.ship_to)
             else ""),
          file=sys.stderr, flush=True)
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        # serve_forever's finally already flushed warm state + closed.
        print("[serve] interrupted; warm state flushed", file=sys.stderr)
    finally:
        if args.trace_out:
            try:
                obs.export(args.trace_out)
                print(f"[serve] trace written to {args.trace_out}",
                      file=sys.stderr)
            except OSError as e:
                print(f"[serve] trace export failed: {e}", file=sys.stderr)
            obs.disable()
    return 0


def _build_daemon(args):
    from locust_tpu_torch.serve.daemon import ServeConfig, ServeDaemon

    return ServeDaemon(
        args.host, args.port, _secret(args),
        cfg=ServeConfig(
            max_queue=args.max_queue,
            max_batch=args.max_batch,
            tenant_quota=args.tenant_quota,
            warm_dir=args.warm_dir,
            journal_dir=args.journal_dir,
            workers=tuple(
                w.strip() for w in (args.workers or "").split(",")
                if w.strip()
            ),
            shard_min_blocks=args.shard_min_blocks,
            ship_to=args.ship_to,
            standby_of=args.standby_of,
            lease_s=args.lease,
        ),
        device=args.backend,
    )


def _client(args):
    from locust_tpu_torch.serve.client import ServeClient

    # --daemon H:P[,H:P...] is the HA roster spelling: the client tries
    # each address, follows not_primary redirects, and sticks to
    # whoever answers — submit/result/stats survive a takeover without
    # the operator editing commands (docs/SERVING.md).
    addr = getattr(args, "daemon", None) or (args.host, args.port)
    return ServeClient(addr, _secret(args))


def _add_daemon_arg(p) -> None:
    p.add_argument("--daemon", default=None, metavar="H:P[,H:P]",
                   help="daemon address roster (overrides --host/--port): "
                        "multiple addresses = HA failover, the client "
                        "follows not_primary redirects transparently")


def _submit_main(argv) -> int:
    p = argparse.ArgumentParser(prog="locust-serve submit")
    p.add_argument("file", help="corpus file (sent inline)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1347)
    p.add_argument("--secret-env", default="LOCUST_SECRET")
    _add_daemon_arg(p)
    p.add_argument("--tenant", default="default")
    # Default None, not "wordcount": an explicitly named workload must
    # stay distinguishable so --plan + --workload is a loud conflict
    # (the client fills in the wordcount default for plain submits).
    p.add_argument("--workload", default=None)
    p.add_argument("--weight", type=float, default=1.0)
    p.add_argument("--block-lines", type=int, default=None)
    p.add_argument("--sort-mode", default=None)
    p.add_argument("--table-size", type=int, default=None)
    p.add_argument("--line-width", type=int, default=None)
    p.add_argument("--key-width", type=int, default=None)
    p.add_argument("--emits-per-line", type=int, default=None)
    p.add_argument("--deadline", type=float, default=None, metavar="S",
                   help="whole-job deadline: expiry anywhere answers the "
                        "structured deadline_exceeded code")
    p.add_argument("--max-attempts", type=int, default=None, metavar="N",
                   help="dispatches this job may kill before it is "
                        "quarantined as poison_job (default 4)")
    p.add_argument("--invalidate", action="store_true",
                   help="drop any cached result for this job first")
    p.add_argument("--no-wait", action="store_true",
                   help="print the job id and return without waiting")
    p.add_argument("--plan", default=None, metavar="PLAN.json",
                   help="submit FILE through a composable dataflow plan "
                        "(a JSON plan document, docs/PLAN.md) instead of "
                        "a named workload; the daemon validates it and "
                        "keys its caches off the plan fingerprint")
    args = p.parse_args(argv)
    with open(args.file, "rb") as f:
        corpus = f.read()
    plan_doc = None
    if args.plan is not None:
        if args.workload is not None:
            print("error: submit takes --plan OR --workload, not both",
                  file=sys.stderr)
            return 2
        with open(args.plan, "r", encoding="utf-8") as f:
            plan_doc = f.read()
    config = {
        k: v
        for k, v in (
            ("block_lines", args.block_lines),
            ("sort_mode", args.sort_mode),
            ("table_size", args.table_size),
            ("line_width", args.line_width),
            ("key_width", args.key_width),
            ("emits_per_line", args.emits_per_line),
        )
        if v is not None
    }
    client = _client(args)
    ack = client.submit(
        corpus=corpus, tenant=args.tenant, workload=args.workload,
        config=config or None, weight=args.weight,
        invalidate=args.invalidate,
        deadline_s=args.deadline, max_attempts=args.max_attempts,
        plan=plan_doc,
    )
    print(f"[serve] job {ack['job_id']} {ack['state']}"
          + (" (cached)" if ack.get("cached") else ""), file=sys.stderr)
    if args.no_wait:
        print(ack["job_id"])
        return 0
    _print_result(client.wait(ack["job_id"]))
    return 0


def _print_result(res: dict) -> None:
    if res.get("plan"):
        # A plan job's result is the pipeline's sink-rendered output as
        # ONE (bytes, 0) pair — print it raw, byte-identical to the
        # hand-wired CLI (docs/PLAN.md), not as a key<TAB>count table.
        for k, _ in res["pairs"]:
            sys.stdout.buffer.write(k)
        sys.stdout.buffer.flush()
    else:
        for k, v in sorted(res["pairs"]):
            sys.stdout.buffer.write(k + b"\t" + str(v).encode() + b"\n")
    print(
        f"[serve] {res['distinct']} distinct, cache={res['cache']}, "
        f"latency {res['latency_ms']} ms", file=sys.stderr,
    )


def _result_main(argv) -> int:
    """Fetch a job submitted earlier with ``--no-wait`` — without this
    command a detached submit's id would be a dead end the protocol can
    answer but the CLI cannot."""
    p = argparse.ArgumentParser(prog="locust-serve result")
    p.add_argument("job_id", help="id printed by `submit --no-wait`")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1347)
    p.add_argument("--secret-env", default="LOCUST_SECRET")
    _add_daemon_arg(p)
    p.add_argument("--wait", action="store_true",
                   help="poll until the job finishes instead of "
                        "answering not_done")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="--wait deadline in seconds")
    args = p.parse_args(argv)
    client = _client(args)
    if args.wait:
        res = client.wait(args.job_id, timeout=args.timeout)
    else:
        res = client.result(args.job_id)
    _print_result(res)
    return 0


def _job_main(argv, cmd: str) -> int:
    """``status``/``cancel``: one job's reply, as JSON."""
    p = argparse.ArgumentParser(prog=f"locust-serve {cmd}")
    p.add_argument("job_id")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1347)
    p.add_argument("--secret-env", default="LOCUST_SECRET")
    _add_daemon_arg(p)
    args = p.parse_args(argv)
    client = _client(args)
    reply = (client.status if cmd == "status" else client.cancel)(args.job_id)
    print(json.dumps(reply, indent=2, default=str))
    return 0


def _invalidate_main(argv) -> int:
    p = argparse.ArgumentParser(prog="locust-serve invalidate")
    p.add_argument("--job-id", default=None)
    p.add_argument("--digest", default=None, help="corpus sha256")
    p.add_argument("--spec-fp", default=None, help="job spec fingerprint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1347)
    p.add_argument("--secret-env", default="LOCUST_SECRET")
    _add_daemon_arg(p)
    args = p.parse_args(argv)
    n = _client(args).invalidate(digest=args.digest, spec_fp=args.spec_fp,
                                 job_id=args.job_id)
    print(f"[serve] invalidated {n} cached result(s)", file=sys.stderr)
    return 0


def _stats_main(argv, cmd: str) -> int:
    p = argparse.ArgumentParser(prog=f"locust-serve {cmd}")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1347)
    p.add_argument("--secret-env", default="LOCUST_SECRET")
    _add_daemon_arg(p)
    args = p.parse_args(argv)
    client = _client(args)
    if cmd == "shutdown":
        client.shutdown()
        print("[serve] daemon shutting down", file=sys.stderr)
        return 0
    if cmd == "promote":
        # Fenced takeover (docs/SERVING.md "High availability"): point
        # this at the STANDBY — it bumps the epoch, replays the
        # replicated WAL and starts dispatching; the old primary is
        # fenced out by the higher epoch wherever it reappears.
        res = client.promote()
        print(f"[serve] promoted: role={res['role']} epoch={res['epoch']}",
              file=sys.stderr)
        return 0
    print(json.dumps(client.stats(), indent=2, default=str))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _CLIENT_CMDS:
        from locust_tpu_torch.serve.client import ServeError

        cmd, rest = argv[0], argv[1:]
        try:
            if cmd == "submit":
                return _submit_main(rest)
            if cmd == "result":
                return _result_main(rest)
            if cmd in ("status", "cancel"):
                return _job_main(rest, cmd)
            if cmd == "invalidate":
                return _invalidate_main(rest)
            return _stats_main(rest, cmd)
        except ServeError as e:
            # A structured daemon answer is an exit code + one line,
            # never a traceback.
            print(f"error: {e}", file=sys.stderr)
            return 1
    return _daemon_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
