"""Locust on PyTorch and CUDA: the port of ``locust_tpu`` to an NVIDIA H100.

Single-device WordCount (Map -> Process -> Reduce) with hand-written CUDA
kernels for the tokenizer, the bitonic sort and the fused map->aggregate
step, every sort mode of the JAX package, one-shot, batched, streaming
and crash-resumable runners, the staged CLI, the plan layer (typed
dataflow plans, their optimizer and compiler), the tf-idf, inverted-index
and PageRank apps with their CLI subcommands, the telemetry core
(spans, events, metrics, Chrome-trace export, profiler attribution), the
native C++ reader (built with g++ at first use), the seeded Zipf corpus
generator, the H100 roofline model, the debug invariant checks and the
seeded fault plan; the distributor (``locust_tpu_torch.distributor``:
master, workers and their wire protocol) and the backend tier's circuit
breaker (``locust_tpu_torch.backend``), reached by those module paths as
in the JAX package.  The package imports
torch and numpy, never jax and nothing of ``locust_tpu``.  Entry points
run on CUDA unless the caller asks for the CPU: ``MapReduceEngine(cfg,
device=None)`` and ``python -m locust_tpu_torch FILE --backend cuda|cpu``.
"""
