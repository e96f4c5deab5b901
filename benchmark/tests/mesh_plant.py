"""Faults planted in the four-card TeraSort cell's ranks, and a tiny run of
the cell on a gloo world of 4 CPU processes.

A fault is planted in every rank's process: in rank 0 by the test (or
``world`` below), in ranks 1-3 by running them through this file::

    python benchmark/tests/mesh_plant.py rank FAULT PORT RANK WORKDIR

(``terasort_mesh.rank_command`` patched to do so).  A whole tiny world
with rank 0 in its own process, its result line on stdout::

    python benchmark/tests/mesh_plant.py world FAULT
"""

from __future__ import annotations

import copy
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness, records  # noqa: E402
from benchmark.drivers import terasort_mesh  # noqa: E402

CELL = "ts-huge-mesh4"
RECORDS_PER_RANK = 750


def tiny_context(workdir: str, seconds: float = 0.3, trace: bool = False,
                 seed: int = 2**33 + 5) -> harness.Context:
    """The cell's context with 750 records a rank, on the CPU."""
    cell, config, traffic = harness.resolve(harness.manifest(), CELL)
    config = copy.deepcopy(config)
    config["records_per_rank"] = RECORDS_PER_RANK
    config["records"] = RECORDS_PER_RANK * config["chips"]
    return harness.Context(workload=CELL, cell=cell, config=config, traffic=traffic,
                           seed=seed, seconds=seconds, trace=trace, device="cpu",
                           workdir=workdir)


def _app():
    import locust_tpu_torch.apps.sample_sort as app

    return app


def _data(put, keys: dict):
    """Every rank's records with planted keys: ``{(start, step): key}``."""
    real = records.gensort_records

    def planted(n, seed, device="cuda", first=0):
        got = real(n, seed, device, first)
        for (start, step), key in keys.items():
            got[start::step, :len(key)] = torch.tensor(list(key), dtype=torch.uint8)
        return got

    put(records, "gensort_records", planted)


def _on_output(put, change):
    app = _app()
    real = app.DistributedSort.sort_records

    def sort_records(self, recs, key_bytes):
        out, overflow = real(self, recs, key_bytes)
        return change(self.mesh, out), overflow

    put(app.DistributedSort, "sort_records", sort_records)


def swap_boundary(mesh, out):
    """Ranks 1 and 2 swap rank 1's last record and rank 2's first."""
    import torch.distributed as dist

    if mesh.rank not in (1, 2):
        return out
    peer, at = (2, -1) if mesh.rank == 1 else (1, 0)
    out = out.clone()
    sent = dist.isend(out[at].clone(), peer)
    got = torch.empty_like(out[at])
    dist.recv(got, peer)
    sent.wait()
    out[at] = got
    return out


def plant(fault: str, rank: int, put=setattr) -> None:
    """Plant ``fault`` in this process, which runs rank ``rank``, each
    change made by ``put(obj, name, value)``."""
    app = _app()
    if fault == "none":
        return
    if fault == "swapped_across_boundary":
        _on_output(put, swap_boundary)
    elif fault == "dropped_on_rank_2":
        _on_output(put, lambda mesh, out: out[1:] if mesh.rank == 2 else out)
    elif fault == "key_cut_to_8_bytes":
        _data(put, {(0, 3): b"TeraSort"})
        real = app.DistributedSort.sort_records
        put(app.DistributedSort, "sort_records",
            lambda self, recs, key_bytes: real(self, recs, min(key_bytes, 8)))
    elif fault == "ties_in_wrong_rank_order":
        # Duplicates on every rank; what arrives is taken in the reverse of
        # the senders' order, so equal keys come out receiver-reversed.
        _data(put, {(0, 3): b"duplicate0", (1, 6): b"duplicate1"})
        from locust_tpu_torch.parallel.mesh import Mesh

        real = Mesh.all_to_all
        put(Mesh, "all_to_all", lambda self, x, axis: real(self, x, axis).flip(0))
    elif fault in ("exit_rank_1", "stall_rank_1"):
        if rank != 1:
            return
        real = app.DistributedSort.sort_records
        calls = {"n": 0}

        def sort_records(self, recs, key_bytes):
            calls["n"] += 1
            if calls["n"] == 4:
                if fault == "exit_rank_1":
                    raise RuntimeError("planted: rank 1 fails")
                time.sleep(3600)
            return real(self, recs, key_bytes)

        put(app.DistributedSort, "sort_records", sort_records)
    else:
        raise KeyError(fault)


def command_through_this_file(fault: str):
    """``terasort_mesh.rank_command`` that starts ranks 1- with ``fault``."""
    def command(port, rank, workdir):
        return [sys.executable, os.path.abspath(__file__), "rank", fault, str(port), str(rank),
                workdir]

    return command


def world(fault: str) -> int:
    """A tiny world with rank 0 in this process; prints the result line."""
    torch.set_num_threads(1)
    plant(fault, 0)
    terasort_mesh.rank_command = command_through_this_file(fault)
    terasort_mesh.STALL_S = 10.0
    with tempfile.TemporaryDirectory() as wd:
        ctx = tiny_context(wd, seconds=1.0)
        out = harness.run_cell(ctx)
    print(json.dumps(harness.result_line(harness.manifest(), ctx, out)), flush=True)
    return 0


if __name__ == "__main__":
    mode, fault, args = sys.argv[1], sys.argv[2], sys.argv[3:]
    if mode == "world":
        raise SystemExit(world(fault))
    plant(fault, int(args[1]))
    raise SystemExit(terasort_mesh.rank_main(args))
