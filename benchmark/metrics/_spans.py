"""What the TeraSort readers share: the device time of the traced jobs'
ops launched under the named port spans, in ms a job."""

from __future__ import annotations


def device_ms(record: dict, *names: str):
    """The ms a traced job of the ops launched under any of ``names``;
    None without a trace or when no op was launched under any of them."""
    t = record.get("trace")
    got = (t or {}).get("span_seconds") or {}
    if not t or not t.get("jobs") or not any(n in got for n in names):
        return None
    return sum(got.get(n, 0.0) for n in names) * 1e3 / t["jobs"]
