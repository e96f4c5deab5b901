"""Analyzer configuration: repo root discovery and the package layout.

The defaults live here, not in ``pyproject.toml`` (whose
``[tool.locust-analysis]`` section belongs to the JAX package's gate).
Every repo-relative path a rule anchors on (the fault-site registry,
the obs names, the serve error codes, the plan registries, the RPC
tiers) derives from ONE setting, ``Layout.package``: the same rules can
then sweep a tree rooted at another package of the same shape.
"""

from __future__ import annotations

import dataclasses
import glob
import os

PACKAGE = "locust_tpu_torch"

DEFAULTS = {
    # What the gate sweeps: the port's package and the scripts the card
    # host runs.  The tests/ tree is the JAX gate's (it sweeps the
    # port's tests too).
    "paths": [PACKAGE, "chip_smoke.py", "chip_mesh.py", "chip_kernel_ab.py"],
    "baseline": f"{PACKAGE}/analysis/baseline.json",
}


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a package's anchors live.  ``tests`` is a glob of the suite
    that exercises the package (read as text, never parsed or run);
    ``analyzer_tests`` is the analyzer's own suite, whose fixtures quote
    phantom registry entries and so never count as coverage."""

    package: str = PACKAGE
    tests: str = "tests/test_torch_*.py"
    analyzer_tests: str = "tests/test_torch_analysis*.py"

    @property
    def prefix(self) -> str:
        return self.package + "/"

    def rel(self, sub: str) -> str:
        return f"{self.package}/{sub}"

    def tests_text(self, root: str, exclude_analyzer: bool = False):
        """The suite's concatenated text, None when no file matches."""
        skip = set()
        if exclude_analyzer:
            skip = set(glob.glob(os.path.join(root, self.analyzer_tests)))
        texts = []
        for path in sorted(glob.glob(os.path.join(root, self.tests))):
            if path in skip:
                continue
            try:
                with open(path, encoding="utf-8", errors="replace") as f:
                    texts.append(f.read())
            except OSError:
                continue
        return "\n".join(texts) if texts else None


def find_root(start: str | None = None) -> str:
    """Nearest ancestor holding pyproject.toml; falls back to the repo
    this package is installed from (two levels above this file)."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isfile(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def load_config(root: str) -> dict:
    return {k: list(v) if isinstance(v, list) else v
            for k, v in DEFAULTS.items()}
