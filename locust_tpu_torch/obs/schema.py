"""Trace-document validation against the checked-in JSON schema.

Port of ``locust_tpu/obs/schema.py``.  ``locust_tpu_torch/obs/
trace.schema.json``, the port's own copy of the JAX package's schema, is
the contract every exported timeline must satisfy.  It ships INSIDE the
package (pyproject package-data) so an installed wheel validates the
same as a repo checkout.  The container ships no
``jsonschema`` package, so ``validate_trace`` implements the small
declarative subset the schema uses — type / required / properties /
items / enum — plus the one conditional JSON Schema would need ``if``/
``then`` for: a complete ("X") event must carry ``ts`` and ``dur``, an
instant ("i") must carry ``ts``.

Failures raise ``ValueError`` listing every violation (a schema gate
that reports one error per run is a gate nobody burns down).
"""

from __future__ import annotations

import json
import os

SCHEMA_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "trace.schema.json"
)

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "number": (int, float),
    "integer": int,
    "boolean": bool,
}


def _check(obj, schema: dict, path: str, errors: list[str]) -> None:
    t = schema.get("type")
    if t is not None:
        py = _TYPES.get(t)
        ok = isinstance(obj, py) if py is not None else True
        if t in ("number", "integer") and isinstance(obj, bool):
            ok = False
        if not ok:
            errors.append(f"{path}: expected {t}, got {type(obj).__name__}")
            return
    if "enum" in schema and obj not in schema["enum"]:
        errors.append(f"{path}: {obj!r} not in {schema['enum']}")
    if isinstance(obj, dict):
        for req in schema.get("required", ()):
            if req not in obj:
                errors.append(f"{path}: missing required key {req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in obj:
                _check(obj[key], sub, f"{path}.{key}", errors)
    if isinstance(obj, list) and "items" in schema:
        for i, item in enumerate(obj):
            _check(item, schema["items"], f"{path}[{i}]", errors)


def load_schema(path: str | None = None) -> dict:
    with open(path or SCHEMA_PATH, encoding="utf-8") as f:
        return json.load(f)


def validate_trace(doc: dict, schema_path: str | None = None) -> None:
    """Raise ``ValueError`` (all violations listed) unless ``doc`` is a
    valid exported timeline."""
    errors: list[str] = []
    _check(doc, load_schema(schema_path), "$", errors)
    if isinstance(doc, dict):
        for i, e in enumerate(doc.get("traceEvents") or ()):
            if not isinstance(e, dict):
                continue
            ph = e.get("ph")
            if ph == "X" and not ("ts" in e and "dur" in e):
                errors.append(
                    f"$.traceEvents[{i}]: complete event needs ts and dur"
                )
            elif ph == "i" and "ts" not in e:
                errors.append(f"$.traceEvents[{i}]: instant event needs ts")
    if errors:
        raise ValueError(
            "trace document fails obs/trace.schema.json:\n  "
            + "\n  ".join(errors[:20])
            + ("" if len(errors) <= 20 else f"\n  ... {len(errors) - 20} more")
        )
