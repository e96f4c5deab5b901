"""A run's fold in two forms around one step: ``engine.fold_block(table,
lines)`` (the only code that maps a block and merges it into the table),
then the run's two counters updated in place.  ``Fold`` is the eager
form.  An eager ``bitonic`` fold issues ~117 device ops a block from
Python, which costs the host about four times the device work they
queue (PERF.md section 5); ``FoldGraph`` captures the same step once as
a CUDA graph and issues it as one ``replay()``: the same kernels at the
same shapes, in the same order.

The graph reads and writes static buffers: ``block``, ``table`` and the
counters.  A fold copies the next block into ``block`` and replays; the
step passes ``out=table``, so the reduce writes the new table into
``table`` after the concat has read it, and the table chains with no
copy.  The step's map, sort and reduce spans open twice a capture (the
warm-up and the capture), never in a replay; on the CPU the graph form
runs the step eagerly, so they open once a block.

``eligible`` is the engine's rule: the graph needs a CUDA device, a fold
with no host branch (``bitonic``: the hasht family reads its unresolved
count per fold, ``fused`` its kernel's flag), and the WordCount map
through kernel A (the plain tokenizer copies its delimiter table from
pageable host memory on every call, which a capture cannot hold).

Graphs outlive the engine that captured them (a plan, and so an engine,
is built per job): ``GRAPHS`` keeps them by everything that fixes the
captured step, and a run holds one for its whole length, so two runs
never share static buffers and a later run with the same shapes replays
without a capture.  A graph keeps no engine: ``hold`` lends it the
run's ``fold_block``.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

from locust_tpu_torch import obs
from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.ops.kernels.sort import bitonic_sort_rows
from locust_tpu_torch.ops.kernels.tokenize import tokenize_block_kernel
from locust_tpu_torch.ops.map_stage import wordcount_map

# The kernels whose wrappers count launches in Python: a capture adds
# nothing to them, a replay the launches it holds.
_COUNTED = (tokenize_block_kernel, bitonic_sort_rows)


def eligible(cfg: EngineConfig, map_fn, device: torch.device) -> tuple[bool, str]:
    """Can the engine fold through a ``FoldGraph``?  ``(ok, reason)``,
    decided from the configuration, the raw map function and the device
    alone (nothing is launched)."""
    if device.type != "cuda":
        return False, f"the device is {device}: CUDA graphs need a CUDA device"
    if cfg.sort_mode != "bitonic":
        return False, (f"sort_mode={cfg.sort_mode!r}: only the bitonic fold is captured "
                       "(the hasht family and fused read the device once a fold)")
    if map_fn is not wordcount_map:
        return False, "map_fn is not the wordcount tokenizer"
    if not cfg.use_pallas:
        return False, ("use_pallas is off: the plain tokenizer copies its delimiter table "
                       "from the host on every call")
    return True, ""


def graph_key(cfg: EngineConfig, combine: str, device: torch.device) -> tuple:
    """What fixes a captured body: the device, the block, the emits and
    keys, the table, the combine and the sort."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return (str(device), cfg.block_lines, cfg.line_width, cfg.emits_per_line, cfg.key_width,
            cfg.resolved_table_size, combine, cfg.sort_mode)


class Fold:
    """A run's fold, eager: ``fold`` calls the engine's ``fold_block``,
    looked up on the engine at every block (so one patched on the class
    or on the instance is the one that runs), and rebinds the table."""

    def __init__(self, engine):
        self._engine = engine

    def start(self, acc: KVBatch | None = None, overflow: torch.Tensor | None = None,
              max_distinct: torch.Tensor | None = None) -> None:
        """Begin a run: the table ``acc`` (empty when None), the counters
        copies of the given ones (0 when None)."""
        eng = self._engine
        self.table = eng.empty_table() if acc is None else acc
        self.overflow, self.max_distinct = (
            torch.zeros((), dtype=torch.int32, device=eng.device) if c is None else c.clone()
            for c in (overflow, max_distinct))

    def _step(self, fold_block, lines: torch.Tensor, **out) -> None:
        """Fold ``lines`` into the table: the one place the counters move."""
        self.table, overflow, distinct = fold_block(self.table, lines, **out)
        self.overflow.add_(overflow)
        torch.maximum(self.max_distinct, distinct, out=self.max_distinct)

    def fold(self, block: torch.Tensor) -> None:
        """Fold one block (on the device, or in host memory: copied, from
        page-locked memory asynchronously)."""
        eng = self._engine
        self._step(eng.fold_block, block.to(eng.device, non_blocking=block.is_pinned()))

    def result(self) -> tuple[KVBatch, torch.Tensor, torch.Tensor]:
        """``(table, max_distinct, overflow)``."""
        return self.table, self.max_distinct, self.overflow


class FoldGraph(Fold):
    """The graph form, over static buffers.  On a CUDA device ``capture``
    records the step and ``fold`` replays it; on the CPU, which has no
    graphs, ``fold`` runs the step eagerly over the same buffers, so the
    tests hold the buffers' bookkeeping there.  ``fold_block`` is the
    step's, set by ``FoldGraphs.hold`` for one run."""

    def __init__(self, cfg: EngineConfig, device: torch.device):
        self.block = torch.zeros((cfg.block_lines, cfg.line_width), dtype=torch.uint8,
                                 device=device)
        self.table = KVBatch.empty(cfg.resolved_table_size, cfg.key_lanes, device)
        self.overflow = torch.zeros((), dtype=torch.int32, device=device)
        self.max_distinct = torch.zeros((), dtype=torch.int32, device=device)
        self.fold_block = None
        self._graph = None
        self._launches = (0,) * len(_COUNTED)  # per replay
        self._released = None  # event after the last run's reads of the buffers

    def _graph_step(self) -> None:
        self._step(self.fold_block, self.block, out=self.table)

    def capture(self) -> None:
        """Warm the step up on a side stream (kernel A's scratch for that
        stream, kernel B's occupancy query, the libraries' loads), then
        capture it there.  Neither adds to the launch counters; the
        buffers hold garbage until ``start``.  Kernel A's overflow
        scratch is the capture stream's: two graphs replayed at once on
        two streams must have been captured on two of torch's pooled
        streams."""
        dev = self.block.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        before = [k.launches for k in _COUNTED]
        with obs.span("engine.fold.capture"):
            try:
                with torch.cuda.stream(stream):
                    self._graph_step()
                warm = [k.launches for k in _COUNTED]
                graph = torch.cuda.CUDAGraph()
                # thread_local: other threads' CUDA calls (a reader, a
                # checkpoint writer, another job) go on during a capture.
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                    self._graph_step()
                self._launches = tuple(k.launches - w for k, w in zip(_COUNTED, warm))
            finally:
                for k, b in zip(_COUNTED, before):
                    k.launches = b
        torch.cuda.current_stream(dev).wait_stream(stream)
        self._graph = graph
        obs.metric_inc("engine.fold.graph_captures")

    def start(self, acc: KVBatch | None = None, overflow: torch.Tensor | None = None,
              max_distinct: torch.Tensor | None = None) -> None:
        """Begin a run: the table copied from ``acc`` (empty when None),
        the counters from the given ones (0 when None)."""
        if self._released is not None:
            torch.cuda.current_stream(self.block.device).wait_event(self._released)
        tables = (None,) * 3 if acc is None else acc.tensors()
        for dst, src in zip((*self.table.tensors(), self.overflow, self.max_distinct),
                            (*tables, overflow, max_distinct)):
            if src is None:
                dst.zero_()
            else:
                dst.copy_(src)

    def fold(self, block: torch.Tensor) -> None:
        """Fold one ``[block_lines, line_width]`` block (on the device, or
        in page-locked host memory, copied asynchronously)."""
        self.block.copy_(block, non_blocking=block.is_pinned())
        if self._graph is None:
            self._graph_step()
        else:
            self._graph.replay()
            for k, n in zip(_COUNTED, self._launches):
                k.launches += n
        obs.metric_inc("engine.fold.graph_replays")

    def result(self) -> tuple[KVBatch, torch.Tensor, torch.Tensor]:
        """``(table, max_distinct, overflow)``, cloned: nothing the caller
        keeps aliases a buffer that a later run writes."""
        return self.table.clone(), self.max_distinct.clone(), self.overflow.clone()

    def release(self) -> None:
        """Mark the end of a run's device work on the buffers: the next
        run's ``start`` waits for it on the card, not on the host.  Drops
        the run's ``fold_block``, and with it the run's engine."""
        self.fold_block = None
        if self.block.device.type == "cuda":
            self._released = torch.cuda.Event()
            self._released.record(torch.cuda.current_stream(self.block.device))


class FoldGraphs:
    """Free graphs by ``graph_key``.  ``hold`` hands a run a graph of its
    own for the run's length, capturing one when none is free, so the
    number of graphs is the most runs that ever folded at once."""

    def __init__(self):
        self._free: dict[tuple, list[FoldGraph]] = collections.defaultdict(list)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def hold(self, key: tuple, make, fold_block):
        """``make()`` builds an uncaptured ``FoldGraph`` for ``key``;
        ``fold_block`` is this run's, the one a capture records."""
        with self._lock:
            graph = self._free[key].pop() if self._free[key] else make()
        graph.fold_block = fold_block
        if graph._graph is None and graph.block.device.type == "cuda":
            graph.capture()
        try:
            yield graph
        finally:
            graph.release()
            with self._lock:
                self._free[key].append(graph)


GRAPHS = FoldGraphs()
