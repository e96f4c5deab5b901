"""Command-line entry point: ``FILE [line_start] [line_end] [node_num] [stage]``.

Port of the single-device paths of ``locust_tpu/cli.py``, the
reference's positional contract (reference MapReduce/src/main.cu:362-387)
and its staged execution:

  stage 0 (or absent)  load the ``[line_start, line_end)`` slice, run Map
                       -> Process -> Reduce on one device, print the
                       ``key<TAB>count`` table
  stage 1              the same fold, then write this node's table as an
                       intermediate file (``--intermediate``, ``tsv`` or
                       ``bin``) instead of printing it
  stage 2              read one or more intermediates (each file's format
                       sniffed), sort and segment-reduce the pairs, print
                       the table

``--stream`` folds the file in bounded memory (``run_stream``; under
``--sort-mode fused`` one fused-kernel launch per segment of blocks),
``--checkpoint-dir`` makes the fold crash-resumable, ``--auto-caps`` sizes
the key width and emits per line to the corpus.  The per-stage report
goes to stderr; stdout is byte for byte the JAX CLI's in every mode and
stage.  Runs on CUDA unless ``--backend cpu``; with no GPU it exits with
an error.  The map goes through the tokenizer kernel and the Process
stage defaults to the bitonic kernel (``sort_mode="bitonic"``).

Stages 0 and 1 run the canonical wordcount plan through the plan
compiler (plan/compile.py), as the JAX CLI does: under ``--sort-mode
hasht`` its ``fuse_fold_kernel`` rewrite folds with the fused kernel.
``--mesh`` runs stages 0 and 1 on the flat mesh engine
(parallel/shuffle.py, one rank per process on ``torch.distributed``) and
``--slices S`` on the hierarchical one, printing the JAX CLI's mesh
report on stderr; ``--coordinator/--num-processes/--process-id`` join a
world of processes that each run the same command (only process 0
prints the table).  ``--mesh`` alone is one rank per visible card: a
world of one in this process on a host with one card, and on a host
with more the CLI starts the other ranks itself.
``--trace-out FILE`` exports the run's spans and metrics as a
Chrome-trace timeline; ``--profile-dir DIR`` captures a ``torch.profiler``
trace of the run into DIR.  ``--fault-plan`` (or ``$LOCUST_FAULT_PLAN``)
installs a seeded fault plan (utils/faultplan.py) before any checkpoint
is written.  ``pagerank``, ``index`` and ``tfidf`` as the
first argument select the subcommands of cli_apps.py.
"""

from __future__ import annotations

import argparse
import sys

from locust_tpu_torch import obs  # zero-overhead unless --trace-out
from locust_tpu_torch.config import SORT_MODES

STAGE_SINGLE, STAGE_MAP, STAGE_REDUCE = 0, 1, 2
DEFAULT_INTERMEDIATE = "/tmp/out.txt"  # the reference's path, main.cu:428


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mapreduce",
        description="MapReduce WordCount on PyTorch/CUDA (single device, staged mode)",
    )
    p.add_argument("filename", help="input text file (stage 0/1); ignored for stage 2")
    p.add_argument("line_start", nargs="?", type=int, default=-1)
    p.add_argument("line_end", nargs="?", type=int, default=-1)
    p.add_argument("node_num", nargs="?", type=int, default=0)
    p.add_argument("stage", nargs="?", type=int, default=STAGE_SINGLE,
                   choices=[STAGE_SINGLE, STAGE_MAP, STAGE_REDUCE])
    p.add_argument("--intermediate", "-i", action="append", default=None,
                   help=f"intermediate path(s); default {DEFAULT_INTERMEDIATE}")
    p.add_argument("--inter-format", choices=["tsv", "bin"], default="tsv",
                   help="stage-1 intermediate format: 'tsv' (key\\tvalue text) "
                        "or 'bin' (packed binary KV); stage 2 sniffs each file")
    p.add_argument("--block-lines", type=int, default=4096)
    p.add_argument("--line-width", type=int, default=128)
    p.add_argument("--key-width", type=int, default=32)
    p.add_argument("--emits-per-line", type=int, default=20)
    p.add_argument("--auto-caps", action="store_true",
                   help="size key_width / emits_per_line to the corpus's measured "
                        "maxima (lossless: the same table); with --stream the "
                        "measuring pass re-reads the file in bounded memory")
    p.add_argument("--sort-mode", choices=list(SORT_MODES), default="bitonic",
                   help="Process-stage sort: 'bitonic' (the CUDA kernel), the "
                        "torch.sort modes 'lex', 'hash', 'hashp', 'hashp2', "
                        "'hashp1', 'hash1', 'radix' (LSD counting sort), or the "
                        "hash-table fold: 'hasht' and 'fused' (the fused kernel), "
                        "'hasht-mxu' (matrix-product combine)")
    p.add_argument("--no-timing", action="store_true",
                   help="fold block after block without the per-stage report")
    p.add_argument("--limit", type=int, default=None,
                   help="print only the first N table rows")
    p.add_argument("--checkpoint-dir", default=None,
                   help="crash-resumable block-granular snapshots: a re-run with "
                        "the same corpus and configuration resumes at the last one")
    p.add_argument("--checkpoint-every", type=_positive_int, default=8,
                   help="blocks between snapshots (with --checkpoint-dir)")
    p.add_argument("--sync-checkpoint", action="store_true",
                   help="write snapshots inside the fold loop instead of on the "
                        "background writer (the same files)")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory ingest: stream the file in blocks instead "
                        "of loading it whole")
    p.add_argument("--trace", action="store_true",
                   help="print a wall-clock span report (load/run/output) on stderr")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="record the run's spans/events/metrics and export a "
                        "Chrome-trace/Perfetto JSON timeline to FILE")
    p.add_argument("--fault-plan", default=None,
                   help="fault injection plan: JSON text or a path to a JSON file (also "
                        "$LOCUST_FAULT_PLAN); no cost when unset")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the run (CPU ops, CUDA kernels) "
                        "into this directory as a Chrome-trace JSON")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                   help="device to run on (default cuda; there is no silent "
                        "fallback to the CPU)")
    p.add_argument("--mesh", action="store_true",
                   help="run stage 0/1 on the all-to-all shuffle engine "
                        "(DistributedMapReduce), one rank per process; prints "
                        "per-shard stats on stderr")
    p.add_argument("--slices", type=_positive_int, default=None,
                   help="with --mesh: the hierarchical engine on a [slices, "
                        "ranks/slice] world; the per-round shuffle stays inside "
                        "a slice, slices combine once at the end")
    p.add_argument("--coordinator", default=None,
                   help="multi-process launch: process 0's address host:port; every "
                        "process runs the same command with its own --process-id.  "
                        "Requires --mesh; only process 0 prints the table")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --coordinator: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --coordinator: this process's index")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # The ladder's subcommands (cli_apps.py), dispatched on the first
    # argument so the bare positional WordCount contract stays intact; a
    # FILE literally named "pagerank" needs ./pagerank.
    from locust_tpu_torch import cli_apps

    if argv and argv[0] in cli_apps.SUBCOMMANDS:
        return cli_apps.main(argv[0], argv[1:])
    args = build_parser().parse_args(argv)
    args.argv = argv  # the mesh's other local ranks run the same command
    if (args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None) and not (args.mesh or args.slices):
        print("mapreduce: error: --coordinator/--num-processes/"
              "--process-id require --mesh", file=sys.stderr)
        return 2
    pod = (args.coordinator, args.num_processes, args.process_id)
    if any(v is None for v in pod) and any(v is not None for v in pod):
        print("mapreduce: error: --coordinator, --num-processes and --process-id "
              "go together", file=sys.stderr)
        return 2
    if args.slices:
        args.mesh = True  # --slices implies the mesh engine; never ignore it
    from locust_tpu_torch.engine import resolve_device

    try:
        device = resolve_device(args.backend)
    except RuntimeError as e:
        print(f"mapreduce: error: {e}", file=sys.stderr)
        return 1
    if args.trace_out:
        obs.enable(process="cli")
    from locust_tpu_torch.utils import faultplan

    plan = None
    try:
        # The plan is live before any checkpoint write it is meant to hit.
        plan = faultplan.install(args.fault_plan)
        return _run(args, device)
    except OSError as e:
        print(f"mapreduce: error: {e}", file=sys.stderr)
        return 1

    finally:
        if plan is not None:
            faultplan.deactivate()
        if args.trace_out:
            cli_apps.export_trace(args.trace_out)


def _run(args, device) -> int:
    import contextlib

    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.utils.profiling import SpanTimer, device_trace

    cfg = EngineConfig(
        block_lines=args.block_lines,
        line_width=args.line_width,
        key_width=args.key_width,
        emits_per_line=args.emits_per_line,
        sort_mode=args.sort_mode,
        use_pallas=True,
        async_checkpoint=not args.sync_checkpoint,
    )
    timer = SpanTimer()
    inter = args.intermediate or [DEFAULT_INTERMEDIATE]
    prof = device_trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with prof:
        if args.stage == STAGE_REDUCE:
            rc = _reduce_stage(args, cfg, device, inter, timer)
        elif args.mesh:
            rc = _mesh_stage(args, cfg, device, inter, timer)
        else:
            rc = _fold_stage(args, cfg, device, inter, timer)
    if args.profile_dir:
        print(f"[locust] profiler trace written to {args.profile_dir}", file=sys.stderr)
    return rc


def _auto_caps(args, cfg, timer):
    """--auto-caps: measure once, shrink key_width / emits_per_line to
    their lossless floors; table_size stays the flags' resolution so the
    table is the same either way.  Returns ``(cfg, rows, auto_caps_fp)``:
    the rows when they were loaded to measure them, and the file's
    identity when it was streamed (checked again at the run)."""
    import dataclasses

    from locust_tpu_torch.io import loader

    rows = None
    auto_caps_fp = None
    if args.auto_caps:
        with timer.span("load"), obs.span("cli.load"):
            if args.stream:
                measure = loader.StreamingCorpus(
                    args.filename, cfg.line_width, cfg.block_lines,
                    args.line_start, args.line_end,
                )
                auto_caps_fp = measure.fingerprint()
                max_tok, max_per_line = loader.measure_caps_stream(measure)
            else:
                rows = loader.load_rows(args.filename, cfg.line_width,
                                        args.line_start, args.line_end)
                # The width-cut rows the engine sees, NULs included.
                max_tok, max_per_line = loader.measure_caps([r.tobytes() for r in rows])
        kw, epl = loader.size_caps(max_tok, max_per_line, cfg.key_width, cfg.emits_per_line)
        cfg = dataclasses.replace(cfg, key_width=kw, emits_per_line=epl,
                                  table_size=cfg.resolved_table_size)
        print(f"[locust] auto-caps: max_token={max_tok}B max_tokens/line={max_per_line} "
              f"-> key_width={cfg.key_width} emits_per_line={cfg.emits_per_line}",
              file=sys.stderr)
    return cfg, rows, auto_caps_fp


def _stale_auto_caps(stream, auto_caps_fp) -> bool:
    """True (and the error printed) when the corpus changed between the
    --auto-caps measuring pass and the run."""
    if auto_caps_fp is None or stream.fingerprint() == auto_caps_fp:
        return False
    print("mapreduce: error: corpus changed between the --auto-caps "
          "measuring pass and the run; re-run (or drop --auto-caps for a "
          "file that is being written to)", file=sys.stderr)
    return True


def _fold_stage(args, cfg, device, inter, timer) -> int:
    """Stages 0 and 1: load (or stream) the slice and fold it."""
    from locust_tpu_torch.io import loader
    from locust_tpu_torch.utils.profiling import SpanTimer

    cfg, rows, auto_caps_fp = _auto_caps(args, cfg, timer)

    # WordCount runs as a compiled PLAN: the canonical DAG (source ->
    # tokenize -> group -> sum -> table) lowers back onto the engine, byte
    # for byte the same table; checkpoints land at the fold boundary.
    from locust_tpu_torch.plan import wordcount_plan
    from locust_tpu_torch.plan.compile import compile_plan

    wc_plan = compile_plan(wordcount_plan(), cfg, device=device)
    with timer.span("load"), obs.span("cli.load"):
        if args.stream:
            stream = loader.StreamingCorpus(args.filename, cfg.line_width, cfg.block_lines,
                                            args.line_start, args.line_end)
            if _stale_auto_caps(stream, auto_caps_fp):
                return 1
        else:
            if rows is None:
                rows = loader.load_rows(args.filename, cfg.line_width,
                                        args.line_start, args.line_end)
            print(f"[locust] {rows.shape[0]} lines loaded", file=sys.stderr)
    pairs = None
    with timer.span("run"), obs.span("cli.run"):  # each runner ends in a device sync
        if args.stream:
            kw = {}
            if args.checkpoint_dir:
                kw = dict(checkpoint_dir=args.checkpoint_dir, every=args.checkpoint_every,
                          fingerprint=stream.fingerprint())
            res = wc_plan.run_stream(stream, **kw)
        else:
            pres = wc_plan.run(
                rows,
                timed=not args.no_timing,
                render=False,
                # The staged map node only dumps the table: skip the host
                # finalize its output path would discard.
                finalize=args.stage != STAGE_MAP,
                checkpoint_dir=args.checkpoint_dir or None,
                every=args.checkpoint_every,
            )
            res, pairs = pres.run_result, pres.value
    if res.stream is not None:
        print(f"[locust] stream: {res.stream}", file=sys.stderr)
    if not args.no_timing:
        stages = SpanTimer()
        stages.spans_ms = {
            "Map stage": res.times.map_ms,
            "Process stage": res.times.process_ms,
            "Reduce stage": res.times.reduce_ms,
        }
        print(stages.report(), file=sys.stderr)
    if res.truncated:
        print("[locust] WARN: table capacity exceeded; tail keys dropped", file=sys.stderr)
    with timer.span("output"), obs.span("cli.output"):
        if args.stage == STAGE_MAP:
            res.dump_intermediate(inter[0], args.inter_format)
            print(f"[locust] node {args.node_num}: intermediate written to {inter[0]}",
                  file=sys.stderr)
        else:
            # The plan run already finalized the table; the stream path
            # decodes here.
            _print_table(pairs if pairs is not None else res.to_host_pairs(), args.limit)
    if args.trace:
        print(timer.report(), file=sys.stderr)
    return 0


def _join_world(args, device):
    """This process's place in the mesh world.  With --coordinator (or the
    count and id) it joins that world; ``--mesh`` alone on a host with
    several cards starts one more process per card, each joining a world
    this process serves as rank 0; otherwise a world of one rank forms in
    this process when the engine builds its mesh.  Returns the child
    processes started."""
    import os
    import subprocess

    import torch

    from locust_tpu_torch.parallel import mesh as mesh_mod

    if args.coordinator is not None:
        if args.trace_out and args.process_id:
            # Each process exports its own timeline; rank 0 keeps the name.
            args.trace_out = f"{args.trace_out}.rank{args.process_id}"
        mesh_mod.initialize_multihost(args.coordinator, args.num_processes,
                                      args.process_id, device)
        return []
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n <= 1:
        return []
    store = mesh_mod.coordinator_store(n)
    coordinator = f"127.0.0.1:{store.port}"
    # Each rank imports this checkout's package, from whatever cwd.
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (pkg_parent, os.environ.get("PYTHONPATH")) if p))
    children = [subprocess.Popen(
        [sys.executable, "-m", "locust_tpu_torch", *args.argv, "--coordinator", coordinator,
         "--num-processes", str(n), "--process-id", str(i)],
        stdout=subprocess.DEVNULL, env=env) for i in range(1, n)]
    mesh_mod.initialize_multihost(coordinator, n, 0, device, store)
    return children


def _mesh_stage(args, cfg, device, inter, timer) -> int:
    """Stages 0 and 1 over the mesh: the JAX CLI's ``_run_mesh``.  A world
    this command joined or formed is left again at the end, and the local
    ranks it started are waited for (their failure is this one's)."""
    import torch.distributed as dist

    from locust_tpu_torch.parallel import mesh as mesh_mod

    cfg, rows, auto_caps_fp = _auto_caps(args, cfg, timer)
    own_world = not dist.is_initialized()
    children = _join_world(args, device)
    try:
        rc = _run_mesh(args, cfg, device, inter, timer, rows, auto_caps_fp)
    finally:
        if own_world:
            mesh_mod.shutdown()
        failed = [c.args for c in children if c.wait() != 0]
    if failed:
        print(f"mapreduce: error: mesh ranks failed: {failed}", file=sys.stderr)
        return 1
    return rc


def _run_mesh(args, cfg, device, inter, timer, rows, auto_caps_fp) -> int:
    import time

    from locust_tpu_torch.io import loader, serde
    from locust_tpu_torch.parallel import mesh as mesh_mod

    if args.slices:
        from locust_tpu_torch.parallel.hierarchical import HierarchicalMapReduce

        mesh = mesh_mod.make_mesh_2d(args.slices, device=device)
        dmr = HierarchicalMapReduce(mesh, cfg)
        print(f"[locust] hierarchical mesh: {dmr.n_slices} slice(s) x "
              f"{dmr.devs_per_slice} device(s), {dmr.lines_per_round} "
              f"lines/round, bin_capacity={dmr.bin_capacity}, "
              f"shard_capacity={dmr.shard_capacity}", file=sys.stderr)
    else:
        from locust_tpu_torch.parallel.shuffle import DistributedMapReduce

        mesh = mesh_mod.make_mesh(device=device)
        dmr = DistributedMapReduce(mesh, cfg)
        print(f"[locust] mesh: {dmr.n_dev} device(s), {dmr.lines_per_round} "
              f"lines/round, bin_capacity={dmr.bin_capacity}, "
              f"shard_capacity={dmr.shard_capacity}", file=sys.stderr)
    t0 = time.perf_counter()
    with timer.span("load"), obs.span("cli.load"):
        kw = {}
        if args.checkpoint_dir:
            kw = dict(checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every)
        if args.stream:
            stream = loader.StreamingCorpus(args.filename, cfg.line_width,
                                            dmr.lines_per_round, args.line_start,
                                            args.line_end)
            if _stale_auto_caps(stream, auto_caps_fp):
                return 1
            if args.checkpoint_dir:
                kw["fingerprint"] = stream.fingerprint()
        else:
            if rows is None:
                rows = loader.load_rows(args.filename, cfg.line_width,
                                        args.line_start, args.line_end)
            print(f"[locust] {rows.shape[0]} lines loaded", file=sys.stderr)
    with timer.span("run"), obs.span("cli.run"):
        res = dmr.run_stream(stream, **kw) if args.stream else dmr.run(rows, **kw)
        pairs = res.to_host_pairs()  # gathers every shard
    run_ms = (time.perf_counter() - t0) * 1e3
    # One hash shard per shard_capacity rows: the hierarchical table
    # has devs_per_slice shards, the flat one n_dev.
    shard_live = res.gather()["valid"].reshape(-1, dmr.shard_capacity).sum(axis=1)
    for d in range(shard_live.shape[0]):
        print(f"[locust] shard {d}: {int(shard_live[d])} keys", file=sys.stderr)
    print(f"[locust] distinct={res.distinct} drain_rounds={res.drain_rounds} "
          f"emit_overflow={res.emit_overflow} "
          f"shuffle_overflow={res.shuffle_overflow} "
          f"truncated={res.truncated} total={run_ms:.1f} ms", file=sys.stderr)
    if res.truncated:
        print("[locust] WARN: a shard's table capacity was exceeded; "
              "tail keys dropped", file=sys.stderr)
    with timer.span("output"), obs.span("cli.output"):
        if mesh.rank == 0:  # every rank holds the table; one prints or writes it
            if args.stage == STAGE_MAP:
                serde.write_intermediate(pairs, inter[0], args.inter_format)
                print(f"[locust] node {args.node_num}: intermediate written "
                      f"to {inter[0]}", file=sys.stderr)
            else:
                _print_table(pairs, args.limit)
    if args.trace:
        print(timer.report(), file=sys.stderr)
    return 0


def _reduce_stage(args, cfg, device, inter, timer) -> int:
    """Stage 2: merge the map nodes' intermediates.  The pairs are always
    sorted again, so files may come in any order."""
    import numpy as np
    import torch

    from locust_tpu_torch.core.kv import KVBatch
    from locust_tpu_torch.engine import finalize_host_pairs
    from locust_tpu_torch.io import serde
    from locust_tpu_torch.ops.process_stage import sort_and_compact
    from locust_tpu_torch.ops.reduce_stage import segment_reduce

    with timer.span("load"), obs.span("cli.load"):
        parts = [serde.read_intermediate(path, cfg.key_width) for path in inter]
        keys = np.concatenate([k for k, _ in parts])
        values = np.concatenate([v for _, v in parts])
    print(f"[locust] node {args.node_num}: {keys.shape[0]} intermediate pairs "
          f"from {len(inter)} file(s)", file=sys.stderr)
    batch = KVBatch.from_bytes(
        torch.from_numpy(keys).to(device),
        torch.from_numpy(values).to(device),
        torch.ones(keys.shape[0], dtype=torch.bool, device=device),
    )
    with timer.span("run"), obs.span("cli.run"):  # finalize_host_pairs syncs
        table = segment_reduce(sort_and_compact(batch, cfg.sort_mode))
        pairs = finalize_host_pairs(table)
    with timer.span("output"), obs.span("cli.output"):
        _print_table(pairs, args.limit)
    if args.trace:
        print(timer.report(), file=sys.stderr)
    return 0


def _print_table(pairs: list[tuple[bytes, int]], limit=None) -> None:
    """Final ``key<TAB>count`` table on stdout."""
    for k, v in pairs[: limit if limit is not None else len(pairs)]:
        sys.stdout.buffer.write(k + b"\t" + str(v).encode() + b"\n")
    sys.stdout.flush()


if __name__ == "__main__":
    raise SystemExit(main())
