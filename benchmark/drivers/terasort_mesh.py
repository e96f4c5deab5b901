"""Closed loop of whole global TeraSorts over a world of ranks, one card a
rank: the traffic kind ``terasort_mesh``.

Rank 0 is the harness's process.  It opens the coordinator's store, writes
the run's settings to ``<workdir>/mesh.json`` and starts ranks 1 ..
``chips - 1`` as processes of this module::

    python3 -m benchmark.drivers.terasort_mesh PORT RANK WORKDIR

(each one's output in ``<workdir>/rank<r>.log``).  Every rank joins the
port's process world (``parallel.mesh.initialize_multihost``, rank ``r``
on ``cuda:r``; NCCL when each rank has a card of its own) and makes its
``records_per_rank`` ``gensort -a`` records on its card in set-up
(``benchmark/records.py``), from its own seed (``rank_seed``), numbered
from ``r * records_per_rank``.  Each job is the port's sample sort of them
on every rank, as a node of a global sort runs it::

    DistributedSort(make_mesh(), EngineConfig(key_width=12),
                    rows_per_device=N).sort_records(records, key_bytes=10)

with the configuration's skew factor and sample per rank.  A job ends
with the rank's device sync and a barrier (an all-reduce that carries rank
0's decision to stop), so rank 0's clock covers the slowest rank and every
rank runs the same jobs: one warm job, then jobs back to back until rank
0's window has passed (``common.closed_loop`` on rank 0).  A job's bytes
are 100 a record of every rank, so ``job_MBps`` is the whole input's bytes
over every job of the window over the window's time.

With ``--trace 1`` rank 0 alone runs the profiler and the port's tracer
(from the window's first job): each job's record holds its
``sample_sort.*`` spans (``<phase>_ms``) and the rise of its counters,
the mesh's all-to-all bytes among them; the profiled job's device ops are
summed by the port's span open at their launch.  A program without those
spans or counters leaves them out of the record.

After the window, on every rank: the memory peak, the profile (rank 0),
the program's state freed, then the reference on the rank's card
(``reference/terasort_mesh.py``): the global stable order of every rank's
records by key, each rank's records made again from its seed, and the
rank's last output compared in full with its share of that order.  The
ranks' readings go through the store to rank 0, which sums them under the
configuration's ``limits``: ``wrong_records``, ``unordered_pairs`` (in
each rank and across each rank boundary) and ``dropped_records`` (every
job's overflow, summed over the ranks by the port, plus the records
missing from the ranks' outputs).  The peak is the largest rank's.  A rank
that loaded a forbidden module fails the run.

A watchdog on rank 0 ends the world when a rank exits non-zero or makes
no progress for ``STALL_S`` seconds (each rank touches
``<workdir>/progress.<r>`` as it goes): it kills the other ranks and exits
1, rather than wait out a collective's timeout.  A rank whose parent is
gone exits too.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

from benchmark import harness, records as gensort
from benchmark.drivers import common, terasort
from benchmark.reference import terasort_mesh as reference

# The port's spans and counters a job's record keeps (``terasort``'s, the
# exchange and the mesh's all-to-all counters besides).
SPAN_MS = {**terasort.SPAN_MS, "sample_sort.exchange": "exchange_ms"}
COUNTERS = {**terasort.COUNTERS, "mesh.all_to_all_calls": "a2a_calls",
            "mesh.all_to_all_bytes": "a2a_bytes"}
# Tells a rank's seed apart from any other stream of the run.
RANK_STREAM = 101
# A rank silent this long ends the world; the watchdog looks every second.
STALL_S = 50.0
SETTINGS = "mesh.json"
PREFIX = "bench/terasort_mesh/"


def rank_seed(seed: int, rank: int) -> int:
    """The seed rank ``rank``'s records are made from (``records.py``)."""
    rng = np.random.default_rng(harness.seed_words(seed, RANK_STREAM, rank))
    return int(rng.integers(0, 2**62))


def rank_records(config: dict, seed: int, rank: int, device: str):
    """Rank ``rank``'s ``[records_per_rank, 100]`` records on ``device``."""
    n = config["records_per_rank"]
    return gensort.gensort_records(n, rank_seed(seed, rank), device, first=rank * n)


def rank_command(port: int, rank: int, workdir: str) -> list[str]:
    """The command that runs rank ``rank`` (``rank >= 1``)."""
    return [sys.executable, "-m", "benchmark.drivers.terasort_mesh", str(port), str(rank),
            workdir]


def _counters() -> dict:
    from locust_tpu_torch import obs

    got = obs.metrics_snapshot().get("counters", {})
    return {name: got[name] for name in COUNTERS if name in got}


def program_numbers(t0: float, before: dict) -> tuple[dict, list]:
    """``terasort.program_numbers`` over this driver's spans and counters."""
    from locust_tpu_torch import obs

    tracer = obs.current()
    if tracer is None:
        return {}, []
    spans = [(n, a, b) for n, a, b, _, _ in tracer.spans(thread=threading.get_ident())
             if a >= t0 and n in SPAN_MS]
    out = {key: sum(b - a for n, a, b in spans if n == name) * 1e3
           for name, key in SPAN_MS.items() if any(n == name for n, _, _ in spans)}
    out.update({COUNTERS[name]: int(v - before.get(name, 0))
                for name, v in _counters().items()})
    return out, spans


class Progress:
    """This rank's heartbeat: ``<workdir>/progress.<rank>``, touched as the
    rank goes."""

    def __init__(self, workdir: str, rank: int):
        self.path = os.path.join(workdir, f"progress.{rank}")
        self.beat()

    def beat(self) -> None:
        with open(self.path, "w") as f:
            f.write(f"{time.time()}\n")


class Watchdog(threading.Thread):
    """Rank 0's watch over the world: a rank that exits non-zero, or whose
    heartbeat is ``STALL_S`` old (a rank that exited 0 is done), ends it."""

    def __init__(self, procs: list, workdir: str, ranks: int):
        super().__init__(name="terasort-mesh-watchdog", daemon=True)
        self.procs, self.workdir, self.ranks = procs, workdir, ranks
        self.stop = threading.Event()

    def run(self) -> None:
        while not self.stop.wait(1.0):
            for r, p in enumerate(self.procs, 1):
                if p.poll() not in (None, 0):
                    end_world(self.procs, self.workdir, f"rank {r} exited {p.returncode}", r)
            now, stale = time.time(), []
            for r in range(self.ranks):
                if r and self.procs[r - 1].poll() == 0:
                    continue
                try:
                    age = now - os.path.getmtime(os.path.join(self.workdir, f"progress.{r}"))
                except OSError:
                    continue
                if age > STALL_S:
                    stale.append(r)
            if stale:
                # Ranks waiting in a collective for a stalled peer stall too.
                end_world(self.procs, self.workdir,
                          f"rank(s) {stale} made no progress for {STALL_S:.0f} s",
                          next((r for r in stale if r), None))


def _log_tail(workdir: str, rank: int) -> str:
    try:
        with open(os.path.join(workdir, f"rank{rank}.log"), "rb") as f:
            return f.read()[-4000:].decode(errors="replace")
    except OSError:
        return ""


def end_world(procs: list, workdir: str, why: str, rank: int | None = None) -> None:
    """Kill every other rank and exit 1 at once: a rank left in a
    collective would wait for its peer until the collective's timeout."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    print(f"[bench] {why}: the world ends, no result", file=sys.stderr)
    if rank:
        print(f"[bench] rank {rank}'s log ends:\n{_log_tail(workdir, rank)}", file=sys.stderr)
    sys.stderr.flush()
    os._exit(1)


def make_job(ctx: harness.Context, records, held: dict, ranks: int, rank: int):
    """The job: the port's ``sort_records`` of this rank's records, its
    output kept in ``held["out"]`` until the next job starts, then the
    device sync and the barrier.  The barrier carries rank 0's decision,
    taken on its clock before it: stop once ``ctx.seconds`` have passed
    since the window's first job started; every rank keeps the answer in
    ``held["stop"]``."""
    import torch
    import torch.distributed as dist

    from locust_tpu_torch import obs
    from locust_tpu_torch.apps.sample_sort import DistributedSort
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.parallel import make_mesh

    cfg = ctx.config
    eng, key_bytes = cfg["engine"], cfg["record"]["key_bytes"]
    n = int(records.shape[0])
    size = cfg["record"]["bytes"] * n * ranks
    traced_jobs = ctx.traffic["trace_jobs"]

    def job(i: int) -> dict:
        if i == 0:
            held["deadline"] = time.perf_counter() + ctx.seconds
            if ctx.trace:
                obs.enable(process="bench")
        held["out"] = None
        spans = common.JobSpans(ctx)
        before, t0 = _counters(), time.perf_counter()
        with spans.span("job"):
            sorter = DistributedSort(make_mesh(device=ctx.device),
                                     EngineConfig(key_width=eng["key_width"]), rows_per_device=n,
                                     skew_factor=eng["skew_factor"],
                                     sample_per_device=eng["sample_per_device"])
            out, overflow = sorter.sort_records(records, key_bytes=key_bytes)
            common.sync(ctx.device)
            stop = rank == 0 and i >= 0 and time.perf_counter() >= held["deadline"]
            flag = torch.tensor([int(stop)], device=out.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            held["stop"] = bool(flag.item())
        held["out"] = out
        held["progress"].beat()
        numbers, own = program_numbers(t0, before)
        if 0 <= i < traced_jobs:
            held["port_spans"].extend(own)
            for name, a, b in own:
                ctx.spans.add(name, a, b)
        return dict(bytes=size, pairs=None, overflow=int(overflow),
                    out_records=int(out.shape[0]), **spans.ms, **numbers)

    return job


def _key_hex(row) -> str:
    return bytes(row.cpu().tolist()).hex()


def rank_run(ctx: harness.Context, rank: int, ranks: int, store, workdir: str) -> dict:
    """Everything one rank does: join, set up, the jobs, then the check of
    its output.  On rank 0 the loop is ``common.closed_loop`` and the
    ranks' readings are summed; returns rank 0's driver output (an empty
    dict on the others)."""
    import torch

    from locust_tpu_torch import obs
    from locust_tpu_torch.parallel import mesh

    progress = Progress(workdir, rank)
    cfg, rec = ctx.config, ctx.config["record"]
    dev = mesh.initialize_multihost(f"127.0.0.1:{store.port}", ranks, rank, ctx.device,
                                    store=store)
    progress.beat()
    t0 = time.perf_counter()
    records = rank_records(cfg, ctx.seed, rank, str(dev))
    common.sync(ctx.device)
    n = int(records.shape[0])
    ctx.log(f"rank {rank}: {n} records of {rec['bytes']} bytes made on {dev} in "
            f"{time.perf_counter() - t0:.3f} s")
    held = {"out": None, "port_spans": [], "stop": False, "progress": progress}
    job = make_job(ctx, records, held, ranks, rank)
    if rank == 0:
        loop = common.closed_loop(ctx, job, ctx.traffic["trace_jobs"],
                                  go_on=lambda t_w0: not held["stop"])
        jobs = loop["records"]
    else:
        job(-1)
        jobs = []
        while not held["stop"]:
            jobs.append(job(len(jobs)))
    del job
    peak = common.memory_peak(ctx)
    trace = terasort.profile_of(ctx, loop, held["port_spans"]) if rank == 0 else None
    if ctx.trace:
        obs.disable()
    got = held.pop("out")
    m = int(got.shape[0])
    edge = [_key_hex(got[0]), _key_hex(got[-1])] if m else None
    store.set(f"{PREFIX}count/{rank}", json.dumps({"m": m, "edge": edge}))
    mesh.shutdown()
    del records
    common.free_device(ctx)
    progress.beat()
    counts = [json.loads(store.get(f"{PREFIX}count/{r}")) for r in range(ranks)]
    t0 = time.perf_counter()

    def make(r: int):
        progress.beat()
        return rank_records(cfg, ctx.seed, r, str(dev))

    order, sizes = reference.global_order(make, ranks, rec["key_bytes"])
    lo = sum(c["m"] for c in counts[:rank])
    want = reference.share(order, lo, m, sizes, make)
    del order
    got_vs = reference.one.compare(got, want, rec["key_bytes"])
    ctx.log(f"rank {rank}: reference over {sum(sizes)} records and the compare of its {m} in "
            f"{time.perf_counter() - t0:.3f} s; {got_vs}")
    del got, want
    mine = {"wrong_records": got_vs["wrong_records"],
            "unordered_pairs": got_vs["unordered_pairs"], "peak": int(peak),
            "out_records": [j["out_records"] for j in jobs],
            "forbidden": harness.forbidden_loaded()}
    store.set(f"{PREFIX}result/{rank}", json.dumps(mine))
    progress.beat()
    if rank:
        return {}
    results = [json.loads(store.get(f"{PREFIX}result/{r}")) for r in range(ranks)]
    bad = {r: x["forbidden"] for r, x in enumerate(results) if x["forbidden"]}
    if bad:
        raise RuntimeError(f"forbidden modules loaded by rank(s) {bad}")
    if any(len(x["out_records"]) != len(jobs) for x in results):
        raise RuntimeError(f"the ranks ran different numbers of jobs: "
                           f"{[len(x['out_records']) for x in results]}")
    total = n * ranks
    dropped = sum(j["overflow"] + max(total - sum(x["out_records"][i] for x in results), 0)
                  for i, j in enumerate(jobs))
    edges = [None if c["edge"] is None else
             [torch.tensor(list(bytes.fromhex(h)), dtype=torch.uint8) for h in c["edge"]]
             for c in counts]
    values = {"wrong_records": sum(x["wrong_records"] for x in results),
              "unordered_pairs": sum(x["unordered_pairs"] for x in results)
              + reference.boundary_pairs(edges, rec["key_bytes"]),
              "dropped_records": dropped}
    ctx.log(f"checks over {ranks} ranks: {values}; each rank's last output "
            f"{[c['m'] for c in counts]} records; peaks {[x['peak'] for x in results]} bytes")
    limits = cfg["limits"]
    checks = [harness.Check(k, values[k], limits[k]["limit"]) for k in values]
    if trace is not None:
        trace["jobs"] = loop["traced_jobs"]
    device = common.device_info(ctx, ranks, max(x["peak"] for x in results))
    record = {"jobs": jobs, "trace": trace, "config": cfg, "device_name": device["kind"],
              "records": {"n": total, "record_bytes": rec["bytes"],
                          "key_bytes": rec["key_bytes"]},
              "rank_peaks": [x["peak"] for x in results]}
    return {"attempted": len(jobs), "failed": 0, "setup_s": loop["setup_s"],
            "e2e": {ctx.traffic["metric"]: loop["job_MBps"]}, "record": record,
            "checks": checks, "device": device}


def run(ctx: harness.Context) -> dict:
    """Rank 0: start the other ranks, run this rank, and collect."""
    from locust_tpu_torch.parallel import mesh

    ranks = int(ctx.config["chips"])
    store = mesh.coordinator_store(ranks)
    with open(os.path.join(ctx.workdir, SETTINGS), "w") as f:
        json.dump({"workload": ctx.workload, "cell": ctx.cell, "config": ctx.config,
                   "traffic": ctx.traffic, "seed": ctx.seed, "seconds": ctx.seconds,
                   "device": ctx.device, "ranks": ranks}, f)
    procs = []
    watchdog = Watchdog(procs, ctx.workdir, ranks)
    try:
        for r in range(1, ranks):
            with open(os.path.join(ctx.workdir, f"rank{r}.log"), "wb") as log:
                procs.append(subprocess.Popen(rank_command(store.port, r, ctx.workdir),
                                              cwd=harness.ROOT, stdout=log,
                                              stderr=subprocess.STDOUT))
        watchdog.start()
        out = rank_run(ctx, 0, ranks, store, ctx.workdir)
        for r, p in enumerate(procs, 1):
            rc = p.wait(timeout=STALL_S)
            if rc != 0:
                raise RuntimeError(f"rank {r} exited {rc}:\n{_log_tail(ctx.workdir, r)}")
        watchdog.stop.set()
        return out
    except BaseException:  # noqa: BLE001 - any failure ends the world at once
        traceback.print_exc()
        # A peer's crash often reaches rank 0 as a failed collective first.
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and not any(p.poll() for p in procs):
            time.sleep(0.05)
        dead = [(r, p.returncode) for r, p in enumerate(procs, 1) if p.poll()]
        end_world(procs, ctx.workdir, "rank 0 failed" + "".join(
            f", rank {r} exited {rc}" for r, rc in dead), dead[0][0] if dead else None)


def rank_main(argv: list[str]) -> int:
    """Ranks 1 ..: run one rank from rank 0's settings; exit 1 on any
    failure, and at once when rank 0's process is gone."""
    import torch.distributed as dist

    from locust_tpu_torch.parallel import mesh

    port, rank, workdir = int(argv[0]), int(argv[1]), argv[2]
    parent = os.getppid()

    def orphaned() -> None:
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=orphaned, name="terasort-mesh-orphan", daemon=True).start()
    try:
        s = harness.load_json(os.path.join(workdir, SETTINGS))
        if s["device"] == "cpu":
            import torch

            torch.set_num_threads(1)
        ctx = harness.Context(workload=s["workload"], cell=s["cell"], config=s["config"],
                              traffic=s["traffic"], seed=s["seed"], seconds=s["seconds"],
                              trace=False, device=s["device"], workdir=workdir)
        store = dist.TCPStore("127.0.0.1", port, s["ranks"], False,
                              timeout=mesh.COLLECTIVE_TIMEOUT)
        rank_run(ctx, rank, s["ranks"], store, workdir)
    except BaseException:  # noqa: BLE001 - the rank's one boundary: report, exit 1
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(rank_main(sys.argv[1:]))
