#!/usr/bin/env python3
"""Kernels A and C of the PyTorch/CUDA port, one checkout against another,
on one NVIDIA GPU.

    python3 chip_kernel_ab.py BASE_ROOT NEW_ROOT

Each ROOT is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Runs base, new, new, base, each in its own process that imports
``locust_tpu_torch`` from its ROOT, builds the two kernels there and times
``tokenize_block_kernel`` and ``fused_block_preagg`` at the main path's
shapes (the CLI's defaults: a 4,096-line block of 128-byte rows of
``data/sample_corpus.txt``, 20 emits, 32-byte keys): wall time (CUDA
events around 200 back-to-back calls, host dispatch included) and, from
``torch.profiler``, the device ops per call, their device time and the
kernel's own.  Prints one JSON line per run, the card's name and power
limit, and last a JSON line with each checkout's mean over its two runs.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

KERNELS = {"tokenize": "tokenize_kernel", "fused_fold": "fused_preagg_kernel"}


def _child(root: str) -> dict:
    import importlib.util

    import numpy as np
    import torch

    # The timing helpers of the chip_smoke.py beside this script; the
    # package under test from ROOT.
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    from locust_tpu_torch import _build
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.core import bytes_ops
    from locust_tpu_torch.ops.kernels.fused_fold import fused_block_preagg
    from locust_tpu_torch.ops.kernels.tokenize import tokenize_block_kernel

    _build.build(("tokenize", "fused_fold"))
    cfg = EngineConfig(sort_mode="fused")
    E, K, W, BL = cfg.emits_per_line, cfg.key_width, cfg.line_width, cfg.block_lines
    with open(os.path.join(root, "data", "sample_corpus.txt"), "rb") as f:
        base = f.read().splitlines()
    rows = bytes_ops.strings_to_rows((base * (BL // len(base) + 1))[:BL], W)
    x = torch.from_numpy(np.ascontiguousarray(rows)).cuda()
    calls = {"tokenize": lambda: tokenize_block_kernel(x, E, K),
             "fused_fold": lambda: fused_block_preagg(x, cfg)}
    out = {"root": root}
    for name, fn in calls.items():
        out[name] = {"wall_ms": smoke.cuda_ms(torch, fn, reps=200, warmup=50)}
    for name, fn in calls.items():
        ops, total, own = smoke.call_profile(torch, fn, KERNELS[name])
        out[name].update(device_ops_per_call=ops, device_ms=total, kernel_device_ms=own)
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(_child(os.path.abspath(argv[1]))), flush=True)
        return 0
    if len(argv) != 2:
        raise SystemExit(__doc__)
    roots = {"base": os.path.abspath(argv[0]), "new": os.path.abspath(argv[1])}
    runs = {"base": [], "new": []}
    for which in ("base", "new", "new", "base"):
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": roots[which]}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", roots[which]],
                              env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{which} run failed:\n{proc.stdout}\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[which].append(res)
        print(json.dumps({"run": which, **res}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    mean = {which: {k: {m: sum(r[k][m] for r in rs) / len(rs) for m in rs[0][k]}
                    for k in KERNELS} for which, rs in runs.items()}
    print(json.dumps({"card": smi, "mean_of_two_runs": mean}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
