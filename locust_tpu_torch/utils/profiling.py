"""Wall-clock stage spans.

Port of ``SpanTimer`` from ``locust_tpu/utils/profiling.py``: named
spans accumulated per name, each ending when the tensors passed to it are
done on the device (``torch.cuda.synchronize`` for a CUDA tensor), and a
report in the JAX CLI's format.  The JAX module's xplane trace parsing
waits for the port's obs tier.
"""

from __future__ import annotations

import contextlib
import time

import torch


class SpanTimer:
    """Named wall-clock spans, syncing the given tensors' devices at span
    EXIT.  Entry does not sync: device work still in flight from before
    the span is billed to it unless an earlier span synced it."""

    def __init__(self):
        self.spans_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, *sync_refs: torch.Tensor):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for ref in sync_refs:
                if ref.device.type == "cuda":
                    torch.cuda.synchronize(ref.device)
            self.spans_ms[name] = self.spans_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def report(self) -> str:
        """Spans by descending time with a percent-of-total column; ties
        break on the name, so repeated reports diff cleanly."""
        if not self.spans_ms:
            return ""
        total = sum(self.spans_ms.values())
        width = max(len(k) for k in self.spans_ms)
        rows = sorted(self.spans_ms.items(), key=lambda kv: (-kv[1], kv[0]))
        return "\n".join(
            f"{k.ljust(width)}  {v:10.3f} ms  "
            f"{(100.0 * v / total if total else 0.0):5.1f}%"
            for k, v in rows
        )
