"""``chip_smoke.py``'s PageRank, mesh and mesh apps phases alone, on this
host's cards.

    python3 chip_mesh.py [pagerank] [mesh] [mesh_apps] [--report FILE]

Builds the kernels, then runs the named phases (all three by default)
over the same 32 MiB replicated corpus and web-Google-sized graph as
``chip_smoke.py``, with the same checks and launch predictions.  On a
host with several cards ``--mesh`` alone forms one NCCL rank per card
(``pagerank --mesh`` and ``index --mesh`` too, in the mesh apps phase).
``--report FILE`` writes the mesh phases' reports as JSON.  Exits 1 when
no card is visible.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import tempfile
import time
import types

import chip_smoke as smoke


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_mesh: no CUDA device", file=sys.stderr)
        return 1
    from locust_tpu_torch import _build
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.core import bytes_ops

    report = None
    if "--report" in argv:
        i = argv.index("--report")
        report, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    which = argv or ["pagerank", "mesh", "mesh_apps"]
    t0 = time.perf_counter()
    _build.build()
    smi = smoke._run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smoke.log(f"cards: {smi}; {torch.cuda.device_count()} visible")
    lines, _ = smoke.replicated_corpus(smoke.TARGET_BYTES)
    block_lines, width = 4096, 128
    oracle = sorted(smoke.oracle_wordcount(lines, width, 20, 32).items())
    by_path, expected = {}, smoke._Expected()

    def median_s(fn, n=3):
        runs = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
        return float(np.median(runs)), runs

    with tempfile.TemporaryDirectory(prefix="chip_mesh_") as work:
        corpus = os.path.join(work, "corpus.txt")
        with open(corpus, "wb") as f:
            f.write(b"\n".join(lines) + b"\n")
        env = types.SimpleNamespace(
            torch=torch, dev=torch.device("cuda"), lines=lines, BL=block_lines, work=work,
            corpus_file=corpus, want=b"".join(k + b"\t" + str(v).encode() + b"\n"
                                              for k, v in oracle),
            nblocks=-(-len(lines) // block_lines), by_path=by_path, expected=expected,
            run_cli=functools.partial(smoke.run_cli_counted, by_path),
            check_counts=functools.partial(smoke.check_launches, by_path, expected),
            counted=smoke.counted, median_s=median_s, smi=smi, cli_extra=[],
            mesh_ckpt_every=8, mesh_crash_gen=24,
            cfg=EngineConfig(sort_mode="bitonic", use_pallas=True),
            rows=bytes_ops.strings_to_rows(lines, width))
        reps = {}
        if "pagerank" in which:
            smoke.pagerank_phase(env)
        if "mesh" in which:
            reps["mesh"] = smoke.mesh_phase(env)
        if "mesh_apps" in which:
            reps["mesh_apps"] = smoke.mesh_apps_phase(env)
        if report:
            with open(report, "w") as f:
                json.dump(reps, f, indent=1)
    smoke.log(f"done in {time.perf_counter() - t0:.1f} s; {smi}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
