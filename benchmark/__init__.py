"""The benchmark of the PyTorch/CUDA port (``locust_tpu_torch``).

``python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Every
cell, configuration, traffic mix and per-layer metric lives in a file of
its own under this folder, found by the name the manifest gives it (see
``README.md``).  Nothing here imports JAX or the JAX package.
"""
