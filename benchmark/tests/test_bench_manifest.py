"""BENCHMARK.json against the contract's shape, and every name in it
found in its own file."""

import json
import os
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"] and not MAN["paths"][0].endswith("_torch")
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN, indent=2)) < 64 * 1024


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_entry_resolves_to_its_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and one_line(cfg["source"]) and one_line(cfg["why"])
    assert cfg["file"].startswith("benchmark/configs/")
    body = harness.load_json(os.path.join(harness.ROOT, cfg["file"]))
    assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"]
    assert body["source"] == cfg["source"]
    assert body["corpus_bytes"] % body["corpus"]["parts"] == 0
    assert all(NAME.match(k) for k in cfg["reduced"]) and len(cfg["reduced"]) <= 16
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_and_reports_what_it_must(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and one_line(cell["why"])
    _, config, traffic = harness.resolve(MAN, cell["name"])
    assert config["chips"] == cell["chips"] in (1, 4)
    assert os.path.exists(os.path.join(harness.BENCH, "drivers", f"{traffic['kind']}.py"))
    e2e = {m["name"] for m in harness.metrics_of(MAN, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.metrics_of(MAN, cell["name"], True)
    assert layer and all(m["moves"] in e2e for m in layer)


def test_pairs_are_unique_and_four_chip_cells_within_the_share():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_shape(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in MAN["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert one_line(metric["layer"])
        assert callable(harness.reader(metric["name"]))
        if "roofline" in metric["name"]:
            assert metric["name"].endswith("_roofline") and metric["unit"] == "%"


def test_names_are_unique():
    for group in (MAN["configs"], MAN["workloads"], MAN["end_to_end"] + MAN["per_layer"]):
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)


def test_every_file_name_under_paths_is_a_name():
    for dirpath, _, files in os.walk(harness.BENCH):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
