"""Locust on PyTorch and CUDA: the port of ``locust_tpu`` to an NVIDIA H100.

Single-device WordCount (Map -> Process -> Reduce) with hand-written CUDA
kernels for the tokenizer, the bitonic sort and the fused map->aggregate
step, every sort mode of the JAX package, one-shot, batched, streaming
and crash-resumable runners, the staged CLI, the plan layer (typed
dataflow plans, their optimizer and compiler), the tf-idf, inverted-index
and PageRank apps with their CLI subcommands, and the telemetry core
(spans, events, metrics, Chrome-trace export).  The package imports
torch and numpy, never jax and nothing of ``locust_tpu``.  Entry points
run on CUDA unless the caller asks for the CPU: ``MapReduceEngine(cfg,
device=None)`` and ``python -m locust_tpu_torch FILE --backend cuda|cpu``.
"""
