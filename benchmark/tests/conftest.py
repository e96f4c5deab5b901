"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root.  The repository's suite (``tests/``) does not collect
them.  Tests that need an NVIDIA card carry the ``chip`` marker and skip
on a machine without one, deciding inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skips without one)")
