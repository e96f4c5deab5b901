#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``locust_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card at the
shapes of the main path, then drives the main path -- single-device
WordCount (Map -> Process -> Reduce) through ``MapReduceEngine.run_fused``,
``MapReduceEngine.timed_run`` and the CLI at the CLI's default widths,
each over >= 32 MiB made by replicating ``data/sample_corpus.txt`` (the
CLI reads it from a file in a temporary directory) -- and checks each
output against a plain Python oracle.  The kernels' launch counters are
set to 0 just before each of the three paths and read just after it;
each path must launch each kernel exactly as often as its blocks demand.
The ``kernels`` line reports the CLI's counts as ``launches`` and all
three in ``launches_by_path``.

Output: one line per check, the card's name and power limit, one JSON
line with each kernel's numbers, and last a JSON line
``{"ok": true, "device": {...}}``.  Every phase raises on failure, so the
script exits non-zero and prints no result; it also refuses to run
without CUDA or without the ``locust_tpu_torch`` package beside it.
Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(HERE, "data", "sample_corpus.txt")
TARGET_BYTES = 32 << 20

# H100 SXM peaks from NVIDIA's data sheet (dense, at the 700 W limit):
# HBM bytes per second, and the float32 rate outside the tensor cores,
# used for int32 compare-exchanges (the data sheet states no int32 rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# The oracle's delimiter set, written out here so it does not come from
# the code under test: the reference's strtok set plus NUL and CR/LF.
_SPLIT = re.compile(b"[" + re.escape(b" ,.-;:'()\"\t" + b"\n\r\x00") + b"]+")


def log(*parts) -> None:
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"== {name}: done in {time.perf_counter() - t0:.3f} s")


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of one call of ``fn`` over ``reps`` back-to-back calls,
    CUDA events around them, after ``warmup`` calls.  Where the host
    dispatches slower than the device runs, this is the dispatch time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_events(torch, fn) -> list:
    """The device-side ops of ``fn()`` as ``torch.profiler`` records them
    (empty when it records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(torch, fn, reps: int = 20) -> float | None:
    """Device time of one call of ``fn``: the summed durations of the
    device ops of ``reps`` calls, over ``reps``.  Unlike ``cuda_ms`` it
    leaves out the host's dispatch time; None when nothing was recorded."""
    fn()
    torch.cuda.synchronize()
    ops = device_events(torch, lambda: [fn() for _ in range(reps)])
    return sum(e.time_range.elapsed_us() for e in ops) / reps / 1e3 if ops else None


def _ms(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def oracle_wordcount(lines, line_width: int, emits: int, key_width: int) -> collections.Counter:
    """strtok semantics with the engine's caps: rows cut to line_width,
    at most ``emits`` tokens per line, keys cut to key_width."""
    per_line = collections.Counter(lines)
    out = collections.Counter()
    for line, times in per_line.items():
        toks = [t for t in _SPLIT.split(line[:line_width]) if t][:emits]
        for t in toks:
            out[t[:key_width]] += times
    return out


def replicated_corpus(target_bytes: int) -> tuple[list[bytes], int]:
    with open(CORPUS, "rb") as f:
        base = f.read().splitlines()
    lines, total = [], 0
    while total < target_bytes:
        for ln in base:
            lines.append(ln)
            total += len(ln) + 1
            if total >= target_bytes:
                break
    return lines, total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "locust_tpu_torch")):
        raise SystemExit("chip_smoke: the locust_tpu_torch package is not beside this script")
    sys.path.insert(0, HERE)
    from locust_tpu_torch import _build, cli
    from locust_tpu_torch.config import EngineConfig
    from locust_tpu_torch.core import bytes_ops
    from locust_tpu_torch.engine import MapReduceEngine
    from locust_tpu_torch.ops.kernels.sort import (
        bitonic_reference,
        bitonic_sort_rows,
        padded_size,
    )
    from locust_tpu_torch.ops.kernels.tokenize import (
        tokenize_block_kernel,
        tokenize_reference,
    )

    dev = torch.device("cuda")

    with phase("machine"):
        log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
        nvcc = _build.nvcc_path()
        log(f"nvcc {nvcc}: {_run([nvcc, '--version']).splitlines()[-1]}")
        try:
            import triton

            log(f"triton {triton.__version__}")
        except ImportError:
            log("triton not importable")
        smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
        log(f"nvidia-smi: {smi}")
        log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    with phase("build kernels"):
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        reports = _build.build()
        log(f"built {sorted(reports)} in {time.perf_counter() - t0:.2f} s")
        for name, report in sorted(reports.items()):
            for line in report.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"  {name}: {line.strip()}")

    cfg = EngineConfig(sort_mode="bitonic", use_pallas=True)  # the CLI's defaults
    E, K, W, BL = cfg.emits_per_line, cfg.key_width, cfg.line_width, cfg.block_lines
    lines, corpus_bytes = replicated_corpus(TARGET_BYTES)
    rows = bytes_ops.strings_to_rows(lines, W)

    with phase("kernel A (tokenizer) against its plain version"):
        rng = np.random.default_rng(0)
        alphabet = np.frombuffer(b"abcdefghij  ,.-\x00\r\n'\"()\t;:QZ\xe9", np.uint8)
        fuzz = alphabet[rng.integers(0, len(alphabet), (BL, W))]
        fuzz[rng.random(BL) < 0.2, 40:100] = ord("w")  # tokens longer than K
        fuzz[rng.random(BL) < 0.1] = ord("x")          # one token filling the row
        blocks = {"fuzz": fuzz, "corpus": rows[:BL], "corpus_tail": rows[-BL:]}
        err_a = 0
        for name, blk in blocks.items():
            x = torch.from_numpy(np.ascontiguousarray(blk)).to(dev)
            keys, valid, ovf = tokenize_block_kernel(x, E, K)
            rkeys, rvalid, rovf = tokenize_reference(x, E, K)
            torch.cuda.synchronize()
            err = max(
                int((keys.int() - rkeys.int()).abs().max()),
                int((valid.int() - rvalid.int()).abs().max()),
                abs(int(ovf) - int(rovf)),
            )
            if err:
                raise AssertionError(f"tokenizer kernel differs from plain on {name}: max abs err {err}")
            err_a = max(err_a, err)
            log(f"  {name} [{BL},{W}] E={E} K={K}: exact, {int(valid.sum())} tokens, overflow {int(ovf)}")

    with phase("kernel B (bitonic sort) against its plain version"):
        err_b = 0
        for n in (1, 1000, 1024, 81920, 131072, 147456, 262144, 1 << 20):
            for kind in ("dups", "equal"):
                g = torch.Generator(device=dev).manual_seed(n)
                if kind == "equal":
                    key = torch.full((n,), 0x12345678, dtype=torch.int32, device=dev)
                else:  # duplicate-heavy, the high bit set on half the keys
                    pool = torch.randint(-(2**31), 2**31 - 1, (max(n // 8, 1),), generator=g,
                                         device=dev, dtype=torch.int64).to(torch.int32)
                    key = pool[torch.randint(0, pool.numel(), (n,), generator=g, device=dev)]
                pay = torch.randint(-(2**31), 2**31 - 1, (n, 9), generator=g, device=dev,
                                    dtype=torch.int64).to(torch.int32)
                pay[:, 0] = torch.arange(n, device=dev, dtype=torch.int32)
                sk, sp = bitonic_sort_rows(key, pay)
                rk, _ = bitonic_reference(key, pay)
                torch.cuda.synchronize()
                err = int((sk.to(torch.int64) - rk.to(torch.int64)).abs().max())
                perm = sp[:, 0].long()
                if err or not torch.equal(torch.sort(perm).values, torch.arange(n, device=dev)) \
                        or not torch.equal(sp, pay[perm]) or not torch.equal(key[perm], sk):
                    raise AssertionError(f"bitonic kernel wrong at n={n} ({kind}): key err {err}")
                err_b = max(err_b, err)
            log(f"  n={n} (pad {padded_size(n)}), 9 payloads, dups + all-equal: exact keys, rows consistent")

    with phase("main path: run_fused, timed_run and the CLI, WordCount over the replicated corpus"):
        log(f"  corpus: {len(lines)} lines, {corpus_bytes} bytes ({corpus_bytes / 2**20:.2f} MiB), "
            f"cfg block_lines={BL} line_width={W} key_width={K} emits={E} "
            f"table={cfg.resolved_table_size} sort_mode={cfg.sort_mode} use_pallas={cfg.use_pallas}")
        oracle = sorted(oracle_wordcount(lines, W, E, K).items())
        nblocks = -(-len(lines) // BL)
        eng = MapReduceEngine(cfg)  # device None: CUDA
        eng.run_fused(rows[: 2 * BL])  # first-call warm-up, outside the counted windows
        torch.cuda.synchronize()

        def counted(fn):
            """Run ``fn`` with both launch counters set to 0 just before it;
            returns its result and the counts read just after it."""
            tokenize_block_kernel.launches = 0
            bitonic_sort_rows.launches = 0
            out = fn()
            torch.cuda.synchronize()
            return out, {"tokenize": tokenize_block_kernel.launches,
                         "bitonic_sort": bitonic_sort_rows.launches}

        # Each path's exact count: one tokenizer launch per block; one
        # sort per block for the fold, two (Process + table merge) for
        # the staged run, which the CLI's default stage report runs.
        expected = {
            "run_fused": {"tokenize": nblocks, "bitonic_sort": nblocks},
            "timed_run": {"tokenize": nblocks, "bitonic_sort": 2 * nblocks},
            "cli": {"tokenize": nblocks, "bitonic_sort": 2 * nblocks},
        }
        by_path = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fused, by_path["run_fused"] = counted(lambda: eng.run_fused(rows))
        fused_s = time.perf_counter() - t0
        timed, by_path["timed_run"] = counted(lambda: eng.timed_run(rows))
        peak_mib = torch.cuda.max_memory_allocated() / 2**20

        # The CLI, as a user calls it, over the same corpus written to a file.
        with tempfile.TemporaryDirectory() as tmp:
            corpus_file = os.path.join(tmp, "corpus.txt")
            with open(corpus_file, "wb") as f:
                f.write(b"\n".join(lines) + b"\n")
            out = io.BytesIO()
            cli_stdout = io.TextIOWrapper(out, write_through=True)
            with contextlib.redirect_stdout(cli_stdout):
                rc, by_path["cli"] = counted(lambda: cli.main([corpus_file]))
            cli_bytes = out.getvalue()

        for name, res in (("run_fused", fused), ("timed_run", timed)):
            pairs = res.to_host_pairs()
            if pairs != oracle or res.truncated:
                raise AssertionError(f"{name}: host pairs differ from the oracle "
                                     f"({len(pairs)} vs {len(oracle)} keys)")
            log(f"  {name}: {len(pairs)} distinct keys == oracle, overflow {res.overflow_tokens}")
        want = b"".join(k + b"\t" + str(v).encode() + b"\n" for k, v in oracle)
        if rc != 0 or cli_bytes != want:
            raise AssertionError("CLI stdout differs from the oracle on the replicated corpus")
        log(f"  CLI (python -m locust_tpu_torch FILE, {corpus_bytes} bytes): stdout == oracle")
        for name, got in by_path.items():
            log(f"  launches in {name} over {nblocks} blocks: {got}, expected {expected[name]}")
            if got != expected[name]:
                raise AssertionError(f"{name} did not launch each kernel as its path must: "
                                     f"{got} != {expected[name]}")
        repeat_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.run_fused(rows)
            torch.cuda.synchronize()
            repeat_s.append(time.perf_counter() - t0)
        log(f"  run_fused: {fused_s * 1e3:.3f} ms, {corpus_bytes / fused_s / 1e6:.3f} MB/s")
        med = float(np.median(repeat_s))
        log(f"  run_fused, {len(repeat_s)} more runs: median {med * 1e3:.3f} ms, "
            f"{corpus_bytes / med / 1e6:.3f} MB/s; runs ms {[round(s * 1e3, 3) for s in repeat_s]}")
        t = timed.times
        log(f"  timed_run: Map {t.map_ms:.3f} ms, Process {t.process_ms:.3f} ms, "
            f"Reduce {t.reduce_ms:.3f} ms, {corpus_bytes / (t.total_ms / 1e3) / 1e6:.3f} MB/s "
            f"over the stage total")
        log(f"  peak device memory (run_fused + timed_run): {peak_mib:.1f} MiB")

    with phase("times at the main path's shapes"):
        x = torch.from_numpy(np.ascontiguousarray(rows[:BL])).to(dev)
        # cuda_ms: events around back-to-back calls, what a caller waits
        # for (host dispatch included); device_ms: the device ops alone.
        def tok_kernel():
            return tokenize_block_kernel(x, E, K)

        def tok_plain():
            return tokenize_reference(x, E, K)

        a_ms, a_plain = cuda_ms(torch, tok_kernel), cuda_ms(torch, tok_plain)
        a_dev, a_plain_dev = device_ms(torch, tok_kernel), device_ms(torch, tok_plain)
        a_bound, a_by = bound_ms(BL * W + BL * E * K + BL * E + 4 * BL + 4, BL * W)
        log(f"  tokenizer [{BL},{W}] E={E} K={K}: kernel {a_ms:.4f} ms (device {_ms(a_dev)}), "
            f"plain {a_plain:.4f} ms (device {_ms(a_plain_dev)}), bound {a_bound:.4f} ms ({a_by})")

        b_rows = {}
        for n in (cfg.resolved_table_size + cfg.emits_per_block, cfg.emits_per_block):
            key = torch.randint(0, 2**31 - 1, (n,), device=dev, dtype=torch.int32)
            pay = torch.randint(0, 2**31 - 1, (n, cfg.key_lanes + 1), device=dev, dtype=torch.int32)

            def sort_kernel():
                return bitonic_sort_rows(key, pay)

            def sort_plain():
                return bitonic_reference(key, pay)

            def sort_library():
                order = torch.sort(key.to(torch.int64) & 0xFFFFFFFF).indices
                return key[order], pay[order]

            times = [(cuda_ms(torch, f), device_ms(torch, f))
                     for f in (sort_kernel, sort_plain, sort_library)]
            kb = padded_size(n).bit_length() - 1
            nbytes = 2 * n * 4 * (1 + pay.shape[1])
            b, by = bound_ms(nbytes, (padded_size(n) // 2) * kb * (kb + 1) // 2)
            b_rows[n] = (times, b, by)
            (k_ms, k_dev), (p_ms, p_dev), (l_ms, l_dev) = times
            log(f"  bitonic n={n} (pad {padded_size(n)}) x {pay.shape[1]} payloads: "
                f"kernel {k_ms:.4f} ms (device {_ms(k_dev)}), plain {p_ms:.4f} ms "
                f"(device {_ms(p_dev)}), torch.sort+gather {l_ms:.4f} ms (device {_ms(l_dev)}), "
                f"bound {b:.4f} ms ({by})")
        fold_n = cfg.resolved_table_size + cfg.emits_per_block
        ((k_ms, k_dev), (p_ms, _), (l_ms, _)), b, by = b_rows[fold_n]

    with phase("where the device time goes: torch.profiler over run_fused, 8 blocks"):
        sub = rows[: 8 * BL]
        kern = device_events(torch, lambda: eng.run_fused(sub))
        if not kern:
            log("  the profiler recorded no device time: busy share not measured")
        else:
            span = max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)
            by_name = collections.Counter()
            for e in kern:
                by_name[e.name[:70]] += e.time_range.elapsed_us()
            busy = sum(by_name.values())
            log(f"  {len(kern)} device ops, busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms "
                f"device window: busy share {busy / span:.3f}")
            for name, us in by_name.most_common(12):
                log(f"  {us / 1e3:9.3f} ms  {us / busy:6.1%}  {name}")

    log(f"card: {smi}")
    report = {"kernels": [
        {"name": "tokenize", "route": "cuda", "status": "ported",
         "source": "locust_tpu_torch/csrc/tokenize.cu",
         "replaces": "locust_tpu/ops/pallas/tokenize.py:35",
         "launches": by_path["cli"]["tokenize"],
         "launches_by_path": {p: c["tokenize"] for p, c in by_path.items()},
         "max_abs_err": err_a,
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound, "bound_by": a_by,
         "library_ms": None, "device_ms": a_dev, "shape": f"[{BL},{W}] E={E} K={K}"},
        {"name": "bitonic_sort", "route": "cuda", "status": "ported",
         "source": "locust_tpu_torch/csrc/bitonic.cu",
         "replaces": "locust_tpu/ops/pallas/sort.py:87",
         "launches": by_path["cli"]["bitonic_sort"],
         "launches_by_path": {p: c["bitonic_sort"] for p, c in by_path.items()},
         "max_abs_err": err_b,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b, "bound_by": by,
         "library_ms": l_ms, "device_ms": k_dev,
         "shape": f"n={fold_n} x {cfg.key_lanes + 1} payloads"},
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
