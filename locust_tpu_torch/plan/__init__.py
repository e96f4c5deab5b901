"""locust_tpu_torch.plan — composable dataflow plans over the engine.

Port of ``locust_tpu/plan``: a typed logical DAG (``nodes.py``) with JSON
round-tripping and a content-addressed fingerprint equal to the JAX
package's, the canonical workload builders (``builders.py``), the
rewrite pass (``optimize.py``) and a compiler (``compile.py``) that
lowers validated plans onto the engine and the apps, single-device.

``compile_plan`` resolves lazily, so validating and fingerprinting a
plan imports neither the engine nor the apps.
"""

from locust_tpu_torch.plan.builders import (  # noqa: F401
    index_plan,
    pagerank_plan,
    tfidf_plan,
    wordcount_plan,
)
from locust_tpu_torch.plan.nodes import (  # noqa: F401
    NODE_KINDS,
    NODE_OPS,
    PLAN_VERSION,
    Node,
    Plan,
    PlanError,
    from_doc,
    from_json,
    node,
)
from locust_tpu_torch.plan.optimize import (  # noqa: F401
    REWRITE_RULES,
    Optimized,
    optimize,
)

_LAZY = ("compile_plan", "CompiledPlan", "PlanResult")


def __getattr__(name: str):
    # PEP 562 lazy re-export: keeps this package importable without the
    # engine modules loaded.
    if name in _LAZY:
        from locust_tpu_torch.plan import compile as _compile

        return getattr(_compile, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
