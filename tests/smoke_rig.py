"""Shared pieces of the rehearsals of ``chip_smoke.py``'s phases on the CPU
(tests/test_torch_build*.py): the script loaded as a module, and each
kernel's plain version counted as its wrapper's launch."""

import functools
import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rehearsal(monkeypatch):
    """``chip_smoke`` with each plain version counted as a launch, in this
    process and in the counted processes a phase starts.  Returns the
    module, the ``by_path`` dict the phase's counts go to, and its
    ``run_cli(name, argv)``."""
    smoke = smoke_module()
    smoke._count_plain_versions(monkeypatch.setattr)
    monkeypatch.setenv(smoke.COUNT_PLAIN_ENV, "1")
    by_path = {}
    return smoke, by_path, functools.partial(smoke.run_cli_counted, by_path)
