"""CLI: ``python -m locust_tpu_torch.analysis [--json] [--sarif FILE]
[--changed[=REF]] [--rule R00x] [paths...]``.

Exit codes: 0 = no new findings (baselined findings may remain and are
reported as such), 1 = new findings, 2 = usage/config error.  The gate
test (tests/test_torch_analysis_gate.py) runs this CLI over the repo.  ``--changed`` scopes the REPORTED findings to
lines touched vs a git ref (the fast pre-commit loop; analysis itself is
always whole-program — the call graph does not shrink with the diff);
``--sarif`` additionally writes the findings as a SARIF 2.1.0 log for
CI/PR annotation.
"""

from __future__ import annotations

import argparse
import sys

from locust_tpu_torch.analysis import config as cfg
from locust_tpu_torch.analysis import run_analysis
from locust_tpu_torch.analysis.baseline import write_baseline
from locust_tpu_torch.analysis.core import changed_lines, emit_json, scope_to_changed
from locust_tpu_torch.analysis.registry import ABSENT, all_rules
from locust_tpu_torch.analysis.sarif import write_sarif


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m locust_tpu_torch.analysis",
        description="locust_tpu_torch static invariant checker "
                    "(docs/ANALYSIS.md)",
    )
    p.add_argument("paths", nargs="*",
                   help="files/dirs to check (default: the package and "
                        "the chip scripts, config.DEFAULTS)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    p.add_argument("--rule", action="append", default=None, metavar="R00x",
                   help="run only this rule (repeatable)")
    p.add_argument("--root", default=None,
                   help="repo root (default: nearest pyproject.toml)")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: "
                        "locust_tpu_torch/analysis/baseline.json)")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept all current findings into the baseline")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="REF",
                   help="report only findings on lines touched vs REF "
                        "(default HEAD) — the fast pre-commit loop; "
                        "analysis still runs whole-program")
    p.add_argument("--sarif", default=None, metavar="FILE",
                   help="also write the findings as a SARIF 2.1.0 log")
    args = p.parse_args(argv)

    if args.changed is not None and args.write_baseline:
        print("error: --write-baseline must see the whole tree; drop "
              "--changed", file=sys.stderr)
        return 2

    if args.list_rules:
        catalog = {rid: rcls.title for rid, rcls in all_rules().items()}
        catalog.update({rid: f"absent — {why}" for rid, why in ABSENT.items()})
        for rid, title in sorted(catalog.items()):
            print(f"{rid}  {title}")
        return 0

    try:
        result = run_analysis(
            paths=args.paths or None,
            root=args.root,
            rules=args.rule,
            baseline_path=args.baseline,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.changed is not None:
        import os

        root = os.path.abspath(args.root or cfg.find_root())
        try:
            result = scope_to_changed(result, changed_lines(root, args.changed))
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    if args.sarif:
        # Rule CLASSES, not bare titles: the report derives helpUri and
        # defaultConfiguration.level per rule from them.
        write_sarif(args.sarif, result, dict(all_rules()))
        print(f"sarif: findings written to {args.sarif}", file=sys.stderr)

    if args.write_baseline:
        root = args.root or cfg.find_root()
        conf = cfg.load_config(root)
        import os

        path = args.baseline or os.path.join(root, conf["baseline"])
        # R000 never enters a baseline: fix the parse error / write the
        # noqa reason instead of accepting it.  Likewise findings marked
        # non-baselineable by their rule (R016 phantom cmds: a cmd with
        # no handler is never acceptable debt) — refuse the whole write
        # loudly rather than silently burying a dead RPC.
        refused = [
            f for f in result.findings
            if f.rule_id != "R000" and not f.baselineable
        ]
        if refused:
            print(
                "error: refusing to baseline non-baselineable "
                "finding(s) — fix them instead:", file=sys.stderr,
            )
            for f in refused:
                print(f"  {f.format()}", file=sys.stderr)
            return 2
        n = write_baseline(
            path, [f for f in result.findings if f.rule_id != "R000"]
        )
        print(f"baseline: {n} finding(s) written to {path}", file=sys.stderr)
        return 0

    if args.as_json:
        print(emit_json(result))
    else:
        for f in result.findings:
            print(f.format())
        print(
            f"{result.n_files} file(s), rules {','.join(result.rules)}: "
            f"{len(result.new)} new finding(s), "
            f"{len(result.findings) - len(result.new)} baselined, "
            f"{result.suppressed} suppressed",
            file=sys.stderr,
        )
    return 1 if result.new else 0


if __name__ == "__main__":
    raise SystemExit(main())
