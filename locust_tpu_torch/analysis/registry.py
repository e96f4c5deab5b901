"""The closed rule registry — itself anti-drift-checked: ``get_rules``
rejects unknown ids loudly, and names the two catalog rules that have
no subject in this package (``ABSENT``) instead of checking nothing."""

from __future__ import annotations

from locust_tpu_torch.analysis.rules_consistency import (
    FaultSiteConsistencyRule,
    WireConstantDriftRule,
)
from locust_tpu_torch.analysis.rules_hygiene import (
    BenchContractRule,
    SubprocessEnvRule,
    TrackedArtifactRule,
)
from locust_tpu_torch.analysis.rules_plan import (
    PlanRegistryRule,
    RewriteRegistryRule,
)
from locust_tpu_torch.analysis.rules_rpc import (
    ChaosCoverageRule,
    RpcSchemaRule,
    SilentThreadDeathRule,
)
from locust_tpu_torch.analysis.rules_serve import ServeErrorRegistryRule
from locust_tpu_torch.analysis.rules_telemetry import TelemetryRegistryRule
from locust_tpu_torch.analysis.rules_threads import (
    ThreadLifecycleRule,
    ThreadSharedStateRule,
    UnboundedBlockingRule,
)
from locust_tpu_torch.analysis.rules_traced import HostSyncInLoopRule

_RULE_CLASSES = (
    ThreadSharedStateRule,      # R001 (interprocedural)
    HostSyncInLoopRule,         # R003 (torch's host reads)
    FaultSiteConsistencyRule,   # R004
    WireConstantDriftRule,      # R005
    SubprocessEnvRule,          # R006
    BenchContractRule,          # R007
    TrackedArtifactRule,        # R008
    TelemetryRegistryRule,      # R009
    ServeErrorRegistryRule,     # R011
    ThreadLifecycleRule,        # R012
    UnboundedBlockingRule,      # R013
    PlanRegistryRule,           # R014
    RewriteRegistryRule,        # R015
    RpcSchemaRule,              # R016 (rpcflow: two-sided schema conformance)
    SilentThreadDeathRule,      # R017 (thread death + silent swallows)
    ChaosCoverageRule,          # R018 (chaos coverage per rpc cmd)
)


# Catalog rules with no subject here: the port traces and donates
# nothing (no torch.compile, no torch.jit, no CUDA-graph capture).
ABSENT = {
    "R002": "traced purity: nothing in the package is traced "
            "(no torch.compile, torch.jit or CUDA-graph capture)",
    "R010": "donated buffers: nothing in the package donates a buffer "
            "(no jit with donate_argnums)",
}


def all_rules() -> dict[str, type]:
    return {cls.rule_id: cls for cls in _RULE_CLASSES}


def get_rules(ids=None, layout=None) -> list:
    """Instantiate the selected rules (all by default) over ``layout``.
    Unknown and absent ids are a loud error — a typo'd --rule must not
    silently check nothing (the same closed-registry stance as
    faultplan.SITES)."""
    table = all_rules()
    if ids is None:
        return [cls(layout) for cls in table.values()]
    out = []
    for rid in ids:
        if rid in ABSENT:
            raise ValueError(f"rule {rid} is absent here: {ABSENT[rid]}")
        if rid not in table:
            raise ValueError(
                f"unknown rule {rid!r} (known: {', '.join(sorted(table))})"
            )
        out.append(table[rid](layout))
    return out
