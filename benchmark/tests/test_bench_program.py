"""The port's own telemetry in tiny runs on the CPU: the cells' runs never
enable the tracer; ``benchmark/program.py`` with it on reads every
number of its ``READERS`` as a finite number, its spans cover the batch
job's fold, and only the dispatching thread's spans name idle gaps."""

import math
import threading

import pytest

from benchmark import program
from benchmark.tests import bench_rig

CELLS = ["wc-zipf30k-batch", "wc-zipf30k-stream"]
# The numbers each cell's traffic gives.
NUMBERS = {
    "wc-zipf30k-batch": ["fold_host_us_per_block", "fold_map_host_us", "fold_sort_host_us",
                         "fold_reduce_host_us", "fold_drain_ms", "stage_blocks_ms",
                         "host_syncs_per_block"],
    "wc-zipf30k-stream": ["reader_read_ms.stream", "reader_wait_ms.stream",
                          "host_syncs_per_block.stream"],
}


@pytest.fixture(autouse=True)
def _telemetry_off():
    from locust_tpu_torch import obs

    obs.disable()
    yield
    obs.disable()


def watch_tracer(mp) -> list:
    """What ``obs.current()`` is at every fold of the run."""
    from locust_tpu_torch import obs
    from locust_tpu_torch.engine import MapReduceEngine

    seen, orig = [], MapReduceEngine.fold_block

    def fold_block(self, acc, lines):
        seen.append(obs.current())
        return orig(self, acc, lines)

    mp.setattr(MapReduceEngine, "fold_block", fold_block)
    return seen


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_a_cells_run_never_enables_the_tracer(workload, trace, monkeypatch):
    seen = watch_tracer(monkeypatch)
    line, _ = bench_rig.run_tiny(workload, trace=trace)
    assert line["correct"] and seen and set(seen) == {None}


@pytest.mark.parametrize("obs_on", [False, True])
def test_program_run_enables_the_tracer_only_when_asked(obs_on, monkeypatch):
    seen = watch_tracer(monkeypatch)
    _, config, _ = bench_rig.tiny("wc-zipf30k-batch")
    line = program.run("wc-zipf30k-batch", 2**33 + 7, 1.0, False, obs_on, "cpu", config)
    assert line["correct"] and ("program" in line) == obs_on
    # The warm job runs without it; every job of the window with it.
    assert seen[0] is None
    assert {t is not None for t in seen[1 + 8:]} == {obs_on}
    from locust_tpu_torch import obs

    assert obs.current() is None


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reads_every_number(workload):
    _, config, _ = bench_rig.tiny(workload)
    line = program.run(workload, 2**40 + 3, 1.0, True, True, "cpu", config)
    assert line["correct"] and line["forbidden"] == []
    got = line["program"]["metrics"]
    for name in NUMBERS[workload]:
        assert isinstance(got[name], float) and math.isfinite(got[name]), (name, got)
    assert got[NUMBERS[workload][-1]] > 0  # host syncs: at least the drain's


def test_the_programs_spans_cover_the_batch_fold():
    """plan.optimize, plan.compile, engine.stage_blocks, the blocks and
    the drain hold at least 90% of each job's ``bench.fold`` span."""
    _, config, _ = bench_rig.tiny("wc-zipf30k-batch")
    line = program.run("wc-zipf30k-batch", 2**35 + 1, 1.0, True, True, "cpu", config)
    prog = line["program"]
    assert prog["fold_cover"] and min(prog["fold_cover"]) >= 0.9, prog["fold_cover"]
    for job in prog["jobs"]:
        fold = job["fold"]
        assert fold["engine.fold.block"][0] == fold["engine.fold.map"][0] == 8
        assert fold["engine.stage_blocks"][0] == fold["engine.fold.drain"][0] == 1
        assert job["other"] == {}
    assert prog["counters"]["engine.host_syncs"] == 2 * len(prog["jobs"])


def test_only_the_dispatching_threads_spans_name_gaps():
    from locust_tpu_torch import obs

    spans = program.ProgramSpans()
    spans.add("bench.fold", 0.0, 1e12)
    assert [s[0] for s in spans.between(0.0, 1e12)] == ["bench.fold"]
    obs.enable()
    with obs.span("engine.fold.block", i=0):
        pass
    other = threading.Thread(target=lambda: obs.span("stream.read").__enter__().__exit__())
    other.start()
    other.join(timeout=10)
    assert [s[0] for s in spans.between(0.0, 1e12)] == ["bench.fold", "engine.fold.block"]


def test_cover_counts_each_instant_once():
    job = {"fold_span": [0.0, 10.0],
           "fold": {"plan.run": [[0.0, 10.0]], "plan.compile": [[-1.0, 1.0]],
                    "engine.fold.block": [[2.0, 4.0], [3.0, 6.0]], "engine.fold.map": [[2.0, 3.0]]}}
    assert program.cover(job) == pytest.approx(0.5)
