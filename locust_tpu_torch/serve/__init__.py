"""locust_tpu_torch.serve — the persistent multi-tenant job service.

The port of ``locust_tpu/serve``: a resident engine daemon
serving concurrent jobs over the distributor's authenticated frame
protocol, with admission control + per-tenant weighted fairness
(scheduler), a warm-executable cache + shape-bucketed batching
(cache/batch + engine.run_batch), a restart-persistent result cache
riding the async snapshot writer (cache.WarmState), and the write-ahead
job journal (journal).  WordCount jobs fold on the daemon's device:
CUDA by default, through kernel B (``sort_mode="bitonic"``) or kernel C
(``"fused"``/``"hasht"``).

    python -m locust_tpu_torch.serve                     # run the daemon
    python -m locust_tpu_torch.serve submit FILE ...     # submit + wait
    python -m locust_tpu_torch.serve stats|shutdown      # operate it

The wire, the journal, the warm file and the stats are the JAX
package's: a client of either package drives a daemon of either, and a
journal or warm directory written by one replays in the other.  The
worker pool (``WorkerPool``: placement by cache affinity, sharding,
distributed plans) and high availability (WAL shipping to a hot standby,
promotion behind a fencing epoch) mix with the JAX package's too.

torch-free at import (the daemon loads the engine when it is
constructed), so clients and supervisors import this without torch.
"""

from locust_tpu_torch.serve.cache import (  # noqa: F401
    ExecutableCache,
    ResultCache,
    WarmState,
    bucket_blocks,
)
from locust_tpu_torch.serve.client import ServeClient, ServeError  # noqa: F401
from locust_tpu_torch.serve.daemon import (  # noqa: F401
    SERVE_COMMANDS,
    ServeConfig,
    ServeDaemon,
)
from locust_tpu_torch.serve.jobs import (  # noqa: F401
    ERROR_CODES,
    JOB_STATES,
    WORKLOADS,
    Job,
    JobSpec,
)
from locust_tpu_torch.serve.journal import JobJournal  # noqa: F401
from locust_tpu_torch.serve.pool import PoolDispatchError, WorkerPool  # noqa: F401
from locust_tpu_torch.serve.scheduler import AdmitReject, FairScheduler  # noqa: F401
