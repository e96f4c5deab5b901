"""Run one cell of ``BENCHMARK.json`` once and print its result line.

The harness knows no cell, configuration, traffic mix or metric by name.
It reads the manifest, finds the cell's configuration file
(``configs``'s ``file``), its traffic file (``traffic/<traffic>.json``),
the driver of the traffic's ``kind`` (``drivers/<kind>.py``) and one
reader per per-layer metric (``metrics/<name>.py``), and hands the
driver a ``Context``.  The driver sets up, runs the measured window,
frees the program's state and checks every answer it keeps against the
plain reference; the harness turns its record into the line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Top-level module names that may not be loaded once the window closed.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "locust_tpu")


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def resolve(man: dict, workload: str, root: str = ROOT) -> tuple[dict, dict, dict]:
    """The cell ``workload`` of the manifest, its configuration and its
    traffic, each read from its own file."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in man["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    return cell, config, load_traffic(cell["traffic"])


def load_config(name: str) -> dict:
    """A configuration by name, from ``configs/<name>.json``."""
    return load_json(os.path.join(BENCH, "configs", f"{name}.json"))


def load_traffic(name: str) -> dict:
    """A traffic mix by name, from ``traffic/<name>.json``."""
    return load_json(os.path.join(BENCH, "traffic", f"{name}.json"))


def metrics_of(man: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    untraced, the per-layer ones traced; a metric with a ``workloads``
    key only in the cells it lists."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seed_words(seed: int, *extra: int) -> list[int]:
    """Entropy for ``numpy.random.default_rng`` from any whole seed."""
    s = abs(int(seed))
    words = [int(seed < 0)]
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return words + [int(e) for e in extra]


class Spans:
    """Host spans of the benchmark's own, on ``time.perf_counter``."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter())

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.items.append((name, t0, t1))

    def between(self, t0: float, t1: float) -> list[tuple[str, float, float]]:
        return [s for s in self.items if s[2] > t0 and s[1] < t1]


@dataclass
class Check:
    """One number compared with its limit: the run is correct only if
    every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Context:
    workload: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = field(default_factory=time.perf_counter)
    workdir: str = ""
    spans: Spans = field(default_factory=Spans)

    def log(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)


def card_report() -> str:
    """The card's name, power limit and clocks as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_loaded() -> list[str]:
    """Forbidden top-level modules in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def result_line(man: dict, ctx: Context, out: dict) -> dict:
    """The run's JSON line from the driver's record ``out``."""
    metrics = {}
    if ctx.trace:
        record = out["record"]
        for m in metrics_of(man, ctx.workload, True):
            value = reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        for m in metrics_of(man, ctx.workload, False):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    checks = out["checks"]
    line = {
        "correct": all(c.ok for c in checks),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": dict(out["device"]),
    }
    trace = out["record"].get("trace") if ctx.trace else None
    if trace is not None:
        line["device"]["busy_s"] = trace["busy_s"]
        line["device"]["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": trace["top_ops"], "idle_gaps": trace["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return line


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(ctx: Context) -> dict:
    """The driver of the cell's traffic kind, run in this process."""
    driver = importlib.import_module(f"benchmark.drivers.{ctx.traffic['kind']}")
    return driver.run(ctx)


def main(argv=None, t_start: float | None = None) -> int:
    args = parse_args(argv)
    man = manifest()
    cell, config, traffic = resolve(man, args.workload)
    # Every build and kernel cache at a fixed path inside the checkout;
    # the port's own kernels build into build/locust_tpu_torch there.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench", sub)
    os.environ["USE_FLAX"] = "0"
    import tempfile

    import torch

    need = int(cell["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"[bench] {args.workload} needs {need} CUDA device(s), found {have}: no result",
              file=sys.stderr)
        return 3
    print(f"[bench] card: {card_report()}", file=sys.stderr, flush=True)
    with tempfile.TemporaryDirectory(prefix="bench-") as workdir:
        ctx = Context(workload=args.workload, cell=cell, config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      t_start=t_start if t_start is not None else time.perf_counter(),
                      workdir=workdir)
        try:
            out = run_cell(ctx)
        except Exception:  # noqa: BLE001 - the run's one boundary: report, no result
            traceback.print_exc()
            return 1
    return report(man, ctx, out)


def report(man: dict, ctx: Context, out: dict) -> int:
    """Print the run's result line, its checks last on stderr; or, where
    this process holds a forbidden module once the window closed, name it
    and print no line (1)."""
    bad = forbidden_loaded()
    if bad:
        print(f"[bench] forbidden modules loaded: {bad}: no result", file=sys.stderr)
        return 1
    line = result_line(man, ctx, out)
    for c in out["checks"]:
        print(f"check {c.name}: {c.value} (limit {c.limit})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
