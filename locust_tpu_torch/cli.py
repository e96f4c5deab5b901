"""CLI driver: single-stage WordCount, ``FILE [line_start] [line_end]``.

Port of the stage-0 path of ``locust_tpu/cli.py``: load the
``[line_start, line_end)`` slice, run Map -> Process -> Reduce on one
device, print the per-stage report on stderr and the ``key<TAB>count``
table on stdout, byte for byte as the JAX CLI prints it.  The staged
modes 1/2, ``--stream``, ``--mesh`` and the rest are later slices.

Runs on CUDA unless ``--backend cpu``; with no GPU it exits with an
error.  The map goes through the tokenizer kernel and the Process stage
defaults to the bitonic kernel (``sort_mode="bitonic"``); ``--sort-mode
hasht`` and ``fused`` fold through the hash table, with each block
pre-aggregated by the fused kernel.
"""

from __future__ import annotations

import argparse
import sys

from locust_tpu_torch.ops.process_stage import PORTED_SORT_MODES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mapreduce",
        description="MapReduce WordCount on PyTorch/CUDA (single device)",
    )
    p.add_argument("filename", help="input text file")
    p.add_argument("line_start", nargs="?", type=int, default=-1)
    p.add_argument("line_end", nargs="?", type=int, default=-1)
    p.add_argument("--block-lines", type=int, default=4096)
    p.add_argument("--line-width", type=int, default=128)
    p.add_argument("--key-width", type=int, default=32)
    p.add_argument("--emits-per-line", type=int, default=20)
    p.add_argument("--sort-mode", choices=list(PORTED_SORT_MODES), default="bitonic",
                   help="Process-stage sort: 'bitonic' (the CUDA kernel), "
                        "'hashp1' (torch.sort of the same folded key), or "
                        "the hash-table fold: 'hasht' and 'fused' (the "
                        "fused kernel), 'hasht-mxu' (matrix-product combine)")
    p.add_argument("--no-timing", action="store_true",
                   help="fold block after block without the per-stage report")
    p.add_argument("--limit", type=int, default=None,
                   help="print only the first N table rows")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                   help="device to run on (default cuda; there is no "
                        "silent fallback to the CPU)")
    return p


def _stage_report(spans_ms: dict[str, float]) -> str:
    """Spans by descending time with a percent-of-total column (the JAX
    CLI's SpanTimer.report format)."""
    total = sum(spans_ms.values())
    width = max(len(k) for k in spans_ms)
    rows = sorted(spans_ms.items(), key=lambda kv: (-kv[1], kv[0]))
    return "\n".join(
        f"{k.ljust(width)}  {v:10.3f} ms  "
        f"{(100.0 * v / total if total else 0.0):5.1f}%"
        for k, v in rows
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.engine import MapReduceEngine, resolve_device
    from locust_tpu_torch.io import loader

    try:
        device = resolve_device(args.backend)
    except RuntimeError as e:
        print(f"mapreduce: error: {e}", file=sys.stderr)
        return 1
    # The JAX compiler's one wordcount rewrite (plan/optimize.py
    # fuse_fold_kernel, applied in plan/compile.py _wordcount_engine): a
    # "hasht" fold runs as "fused", which gives the same table.
    sort_mode = "fused" if args.sort_mode == "hasht" else args.sort_mode
    cfg = EngineConfig(
        block_lines=args.block_lines,
        line_width=args.line_width,
        key_width=args.key_width,
        emits_per_line=args.emits_per_line,
        sort_mode=sort_mode,
        use_pallas=True,
    )
    try:
        rows = loader.load_rows(args.filename, cfg.line_width, args.line_start, args.line_end)
    except OSError as e:
        print(f"mapreduce: error: {e}", file=sys.stderr)
        return 1
    print(f"[locust] {rows.shape[0]} lines loaded", file=sys.stderr)
    eng = MapReduceEngine(cfg, device=device)
    res = eng.run_fused(rows) if args.no_timing else eng.timed_run(rows)
    if not args.no_timing:
        print(_stage_report({
            "Map stage": res.times.map_ms,
            "Process stage": res.times.process_ms,
            "Reduce stage": res.times.reduce_ms,
        }), file=sys.stderr)
    if res.truncated:
        print("[locust] WARN: table capacity exceeded; tail keys dropped",
              file=sys.stderr)
    _print_table(res.to_host_pairs(), args.limit)
    return 0


def _print_table(pairs: list[tuple[bytes, int]], limit=None) -> None:
    """Final ``key<TAB>count`` table on stdout."""
    for k, v in pairs[: limit if limit is not None else len(pairs)]:
        sys.stdout.buffer.write(k + b"\t" + str(v).encode() + b"\n")
    sys.stdout.flush()


if __name__ == "__main__":
    raise SystemExit(main())
