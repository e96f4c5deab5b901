"""PyTorch port, sharded checkpoints across packages where the process
layouts match: a JAX pod of 2 processes (one CPU device each:
``make_mesh()`` is ``2xdata``, as tests/test_multiprocess.py's pod runs
it with its own device count) and a port gloo world of 2, at once.  Each
crashes a checkpointed run before its third round into its own
directory, then resumes the OTHER package's snapshots (``state.p0.npz``,
``state.p1.npz``: the same keys, digests and fingerprints) and must fold
exactly the remaining rounds to the oracle's table.  The world of one
against JAX's ``make_mesh(1)`` is in tests/test_torch_mesh_units.py."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import os

import torch_mesh_rig as rig
from helpers import py_wordcount


def test_two_process_worlds_resume_each_other(tmp_path):
    out = str(tmp_path)
    jax_procs = rig.start_world("jax", 2, out, "resume")
    torch_procs = rig.start_world("torch", 2, out, "resume")
    try:
        got = {"torch": rig.finish_world(torch_procs, out, "torch"),
               "jax": rig.finish_world(jax_procs, out, "jax")}
    finally:
        for p in jax_procs + torch_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    n_lines = got["torch"]["n_lines"]
    assert n_lines == got["jax"]["n_lines"]
    want = {k.hex(): v for k, v in py_wordcount(
        rig.BASE * (n_lines // len(rig.BASE)), 8).items()}
    for pkg, res in got.items():
        r = res["resumed_other"]
        assert dict(map(tuple, r["pairs"])) == want, pkg
        # The other package's snapshot at round 2 was taken and trusted.
        assert r["resumed_rounds"] == r["nrounds"] - 2 and r["nrounds"] == 4, pkg
        assert r["third_run_steps"] == 0 and r["third_run_same"], pkg
    for me in ("jax", "torch"):
        for pid in (0, 1):
            assert os.path.exists(f"{out}/ckpt_{me}/state.p{pid}.npz")
