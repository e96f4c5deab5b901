"""Host-side utilities of the PyTorch port: invariant checks, stage spans
and device-time capture, the roofline model and the fault plan.

The names below resolve lazily (PEP 562), as in the JAX package's
``utils/__init__.py``: importing the package imports none of its
modules.
"""

_EXPORTS = {
    "validate_batch": "locust_tpu_torch.utils.checks",
    "SpanTimer": "locust_tpu_torch.utils.profiling",
    "device_trace": "locust_tpu_torch.utils.profiling",
    "profile_device": "locust_tpu_torch.utils.profiling",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod_name = _EXPORTS.get(name)
    if mod_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), name)
