"""Checked-in baseline: fingerprints of findings that predate the gate.

The shipped baseline is (near-)empty — the PR that introduced the gate
fixed what it found — but the mechanism matters: a NEW rule can land with
its legacy findings baselined instead of blocking, then the baseline
burns down.  Format (JSON, sorted, diff-friendly)::

    {"version": 1,
     "findings": {"<fingerprint>": "<rule> <path>:<line> <message>"}}

The value is a human-readable label only; the KEY (content-addressed
fingerprint, core._fingerprint) is what matching uses, so baselines
survive line-number drift but not edits to the flagged line itself.
"""

from __future__ import annotations

import json
import os


def load_baseline(path: str | None) -> set[str]:
    if not path or not os.path.isfile(path):
        return set()
    try:
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable analysis baseline {path!r}: {e}")
    if not isinstance(obj, dict) or not isinstance(obj.get("findings"), dict):
        raise ValueError(
            f"analysis baseline {path!r} must be "
            '{"version": 1, "findings": {...}}'
        )
    return set(obj["findings"])


def write_baseline(path: str, findings) -> int:
    """Write every (non-suppressed) finding as the new baseline; returns
    the count.  An empty finding list writes an empty baseline — the
    healthy steady state."""
    payload = {
        "version": 1,
        "findings": {
            f.fingerprint: f"{f.rule_id} {f.path}:{f.line} {f.message}"
            for f in findings
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(payload["findings"])
