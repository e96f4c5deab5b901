"""CLI subcommands for the workload ladder beyond WordCount.

Port of ``locust_tpu/cli_apps.py``.  Each subcommand constructs the
workload's canonical logical plan (plan/builders.py) and runs it through
the plan compiler, which lowers onto the apps; stdout is byte for byte
the JAX CLI's (tests/test_torch_cli_apps.py):

  python -m locust_tpu_torch pagerank <edges.txt> [--num-iters N] [--top N]
  python -m locust_tpu_torch index  <file> [--lines-per-doc K] [--limit N]
  python -m locust_tpu_torch tfidf  <file> [--lines-per-doc K] [--limit N]

Edge-list format: one ``src dst`` pair of integer node ids per line;
lines starting with ``#`` are comments (the web-Google / SNAP
convention).  For index/tfidf the doc id of line i is
``i // lines_per_doc`` — line-sharded documents.

Every subcommand runs on CUDA unless ``--backend cpu``, takes
``--trace-out FILE`` (a Chrome-trace timeline of the run) and
``--sort-mode`` (default ``bitonic``: the bitonic kernel; pagerank's
dense pipeline has no sort and accepts it for parity).  index and tfidf
map through the tokenizer kernel.  ``--mesh`` (the JAX package's sharded
engines) exits with an error until the port's mesh tier lands.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from locust_tpu_torch import obs  # zero-overhead unless --trace-out

SUBCOMMANDS = ("pagerank", "index", "tfidf")
PROG = "locust_tpu_torch"


def _add_backend_flag(p: argparse.ArgumentParser) -> None:
    from locust_tpu_torch.config import SORT_MODES

    p.add_argument(
        "--backend", choices=["cuda", "cpu"], default="cuda",
        help="device to run on (default cuda; there is no silent "
             "fallback to the CPU)",
    )
    p.add_argument(
        "--sort-mode", choices=list(SORT_MODES), default="bitonic",
        help="Process-stage sort strategy (config.EngineConfig.sort_mode; "
             "default bitonic, the CUDA kernel).  pagerank accepts it for "
             "parity only — its dense pipeline has no sort.",
    )
    p.add_argument(
        "--trace-out", default=None, metavar="FILE",
        help="record the run's spans/events/metrics (plan.compile/"
             "plan.run + engine stages) and export a Chrome-trace JSON "
             "timeline to FILE",
    )


def build_parser(cmd: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"{PROG} {cmd}")
    if cmd == "pagerank":
        p.add_argument("edges", help="edge list: 'src dst' per line, # comments")
        p.add_argument("--num-iters", type=int, default=20)
        p.add_argument("--damping", type=float, default=0.85)
        p.add_argument("--num-nodes", type=int, default=None,
                       help="default: max node id in the file + 1")
        p.add_argument("--mesh", action="store_true",
                       help="sharded PageRank (not ported yet: exits 2)")
        p.add_argument("--top", type=int, default=None,
                       help="print only the N highest-ranked nodes")
    else:
        p.add_argument("filename", help="input text file")
        p.add_argument("--lines-per-doc", type=int, default=1,
                       help="doc id of line i = i // K (default 1: "
                            "one document per line)")
        p.add_argument("--mesh", action="store_true",
                       help="build across devices (not ported yet: exits 2)")
        p.add_argument("--limit", type=int, default=None,
                       help="print only the first N table rows")
        p.add_argument("--block-lines", type=int, default=4096)
        p.add_argument("--line-width", type=int, default=128)
        p.add_argument("--key-width", type=int, default=32)
        p.add_argument("--emits-per-line", type=int, default=20)
    _add_backend_flag(p)
    return p


def load_edges(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse a SNAP-style edge list; loud error on malformed lines.
    Delegates to the ONE byte-level parser
    (``plan.compile.edges_from_bytes``); the file path is prefixed onto
    any parse error for CLI context."""
    from locust_tpu_torch.plan import PlanError
    from locust_tpu_torch.plan.compile import edges_from_bytes

    with open(path, "rb") as f:
        data = f.read()
    try:
        return edges_from_bytes(data)
    except PlanError as e:
        raise ValueError(f"{path}: {e}")


def run_pagerank(args, device) -> int:
    from locust_tpu_torch.plan import pagerank_plan
    from locust_tpu_torch.plan.compile import compile_plan, rank_row

    src, dst = load_edges(args.edges)
    top_id = max(int(src.max()), int(dst.max()))
    n = args.num_nodes if args.num_nodes is not None else top_id + 1
    if top_id >= n:
        print(f"{PROG}: error: --num-nodes {n} but max node id is {top_id}",
              file=sys.stderr)
        return 1
    ranks = compile_plan(
        pagerank_plan(num_iters=args.num_iters, damping=args.damping),
        device=device,
    ).run((src, dst), num_nodes=n, render=False).value
    order = (
        np.argsort(-ranks, kind="stable")[: args.top]
        if args.top is not None
        else np.arange(n)
    )
    out = sys.stdout.buffer
    for node in order:
        out.write(rank_row(int(node), ranks[node]))
    out.flush()
    return 0


def _load_docs(args):
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.io import loader

    cfg = EngineConfig(
        block_lines=args.block_lines,
        line_width=args.line_width,
        key_width=args.key_width,
        emits_per_line=args.emits_per_line,
        sort_mode=args.sort_mode,
        # The map goes through the tokenizer kernel, as in the WordCount
        # CLI; the keys are the plain tokenizer's either way.
        use_pallas=True,
    )
    rows = loader.load_rows(args.filename, cfg.line_width)
    return cfg, rows


def _print_rendered(op: str, value, limit) -> int:
    """Print through the plan sink's ONE row renderer
    (plan.compile.iter_rendered)."""
    from locust_tpu_torch.plan.compile import iter_rendered

    out = sys.stdout.buffer
    for i, row in enumerate(iter_rendered(op, value)):
        if limit is not None and i >= limit:
            break
        out.write(row)
    out.flush()
    return 0


def run_index(args, device) -> int:
    from locust_tpu_torch.plan import index_plan
    from locust_tpu_torch.plan.compile import compile_plan

    cfg, rows = _load_docs(args)
    index = compile_plan(
        index_plan(args.lines_per_doc), cfg, device=device
    ).run(rows, render=False).value
    return _print_rendered("postings", index, args.limit)


def run_tfidf(args, device) -> int:
    from locust_tpu_torch.plan import tfidf_plan
    from locust_tpu_torch.plan.compile import compile_plan

    cfg, rows = _load_docs(args)
    scores = compile_plan(
        tfidf_plan(args.lines_per_doc), cfg, device=device
    ).run(rows, render=False).value
    return _print_rendered("tfidf", scores, args.limit)


def main(cmd: str, argv) -> int:
    args = build_parser(cmd).parse_args(argv)
    # Argument validation before the device is touched.
    if cmd == "tfidf" and args.mesh:
        print(f"{PROG}: error: tfidf has no mesh variant (the tf pair "
              "table is device-bounded; use index --mesh for the "
              "distributed path)", file=sys.stderr)
        return 2
    if args.mesh:
        print(f"{PROG}: error: --mesh needs the mesh tier (sharded "
              f"{'PageRank' if cmd == 'pagerank' else 'inverted index'} "
              "on torch.distributed), which is not ported yet", file=sys.stderr)
        return 2
    if cmd != "pagerank" and args.lines_per_doc < 1:
        print(f"{PROG}: error: --lines-per-doc must be >= 1", file=sys.stderr)
        return 2
    if cmd == "pagerank":
        if args.num_nodes is not None and args.num_nodes < 1:
            print(f"{PROG}: error: --num-nodes must be >= 1", file=sys.stderr)
            return 2
        if args.top is not None and args.top < 1:
            print(f"{PROG}: error: --top must be >= 1", file=sys.stderr)
            return 2
    from locust_tpu_torch.engine import resolve_device

    try:
        device = resolve_device(args.backend)
    except RuntimeError as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1
    if args.trace_out:
        obs.enable(process="cli")
    try:
        if cmd == "pagerank":
            return run_pagerank(args, device)
        if cmd == "index":
            return run_index(args, device)
        return run_tfidf(args, device)
    except (OSError, ValueError) as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1
    finally:
        if args.trace_out:
            export_trace(args.trace_out)


def export_trace(path: str) -> None:
    """Export the run's timeline and turn telemetry off.  An unwritable
    trace path is a warning, never the exit status."""
    try:
        obs.export(path)
        print(f"[locust] trace written to {path}", file=sys.stderr)
    except OSError as e:
        print(f"[locust] trace export to {path} failed: {e}", file=sys.stderr)
    obs.disable()
