"""SARIF 2.1.0 emission — findings as a standard static-analysis log.

One run, one tool (``locust-analysis``), one result per finding; the
content-addressed fingerprint (core._fingerprint) rides in
``partialFingerprints`` so SARIF consumers dedupe across line drift
exactly like the native baseline does, and ``baselineState`` carries the
new/baselined split.  The shape is the JAX analyzer's, pinned by
tests/test_torch_analysis.py::test_sarif_parity — CI/PR annotators
consume this file without any new infrastructure (docs/ANALYSIS.md).
"""

from __future__ import annotations

import json

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


DEFAULT_HELP_URI = "docs/ANALYSIS.md#rule-catalog"


def _rule_entry(rid: str, val) -> dict:
    """One driver.rules entry.  ``val`` is either a bare title string
    (the legacy catalog shape, kept working) or a Rule class — classes
    contribute ``helpUri`` (the docs/ANALYSIS.md anchor, overridable via
    a ``help_uri`` class attr) and ``defaultConfiguration.level`` derived
    from the rule's ``severity``."""
    if isinstance(val, str):
        return {"id": rid, "shortDescription": {"text": val}}
    sev = getattr(val, "severity", "error")
    return {
        "id": rid,
        "shortDescription": {"text": val.title},
        "helpUri": getattr(val, "help_uri", DEFAULT_HELP_URI),
        "defaultConfiguration": {
            "level": "error" if sev == "error" else "warning",
        },
    }


def sarif_report(result, rule_catalog: dict) -> dict:
    """``AnalysisResult`` + {rule id: title-or-Rule-class} -> a SARIF
    log dict."""
    results = []
    for f in result.findings:
        results.append({
            "ruleId": f.rule_id,
            "level": "error" if f.severity == "error" else "warning",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {
                        "startLine": max(f.line, 1),
                        "startColumn": f.col + 1,
                    },
                },
            }],
            "partialFingerprints": {
                "locustFingerprint/v1": f.fingerprint,
            },
            "baselineState": "unchanged" if f.baselined else "new",
        })
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "locust-analysis",
                    "informationUri": "docs/ANALYSIS.md",
                    "rules": [
                        _rule_entry(rid, val)
                        for rid, val in sorted(rule_catalog.items())
                    ],
                },
            },
            "results": results,
        }],
    }


def write_sarif(path: str, result, rule_catalog: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(sarif_report(result, rule_catalog), f, indent=2,
                  sort_keys=True)
        f.write("\n")
