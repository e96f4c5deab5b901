"""One torch intra-op thread per test process.

Every ``tests/test_torch_*.py`` imports this module first, so each
pytest(-xdist) worker that collects a port test runs torch's CPU ops on
one thread: six workers each running torch's default pool (one thread
per core) oversubscribe the host and stretch small tests 10-70x.  The
python children a port test starts get the same pin through
``OMP_NUM_THREADS=1`` in their ``env=``; ``os.environ`` itself is left
alone, so the JAX tests' numpy and BLAS keep their threads.
"""

import torch

torch.set_num_threads(1)
