"""locust_tpu_torch.analysis — AST-based invariant checker over the port.

The JAX package's static gate (``locust_tpu.analysis``), re-homed: the
same rule catalog (docs/ANALYSIS.md) anchored on this package's own
registries — thread-shared state and unbounded waits in the serve and
distributor tiers, closed registries that drift silently (fault sites,
telemetry names, serve error codes, plan kinds and rewrites, RPC
schemas), host syncs in loops, and the chip scripts' hygiene.  It
imports neither torch nor jax nor anything of ``locust_tpu``.

Usage::

    python -m locust_tpu_torch.analysis [--json] [--rule R00x] [paths...]

Exit code 1 on NEW findings (not in ``analysis/baseline.json``).
Suppress one line with ``# locust: noqa[R00x] <reason>`` — the reason is
mandatory (an empty reason is itself a finding).
"""

from locust_tpu_torch.analysis.core import (  # noqa: F401 - public API
    AnalysisResult,
    Finding,
    SourceFile,
    run_analysis,
)
from locust_tpu_torch.analysis.registry import all_rules, get_rules  # noqa: F401
