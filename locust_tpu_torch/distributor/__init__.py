"""Distributor package: master/worker data plane and the wire protocol.

Port of ``locust_tpu/distributor``.  Submodules resolve lazily (PEP
562), as in the JAX package: ``from locust_tpu_torch.distributor import
master`` imports the master when asked, and a client that needs only the
wire layer (``protocol``) pays for nothing else.
"""

import importlib

_SUBMODULES = ("master", "microbench", "protocol", "worker")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"locust_tpu_torch.distributor.{name}")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
