"""BENCHMARK.json keeps the benchmark's contract: allowed names and units,
every file found by name, every per-layer metric reported where it says."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as _fh:
    BENCH = json.load(_fh)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _all_names():
    out = []
    for c in BENCH["configs"]:
        out += [c["name"], *c["reduced"]]
    for w in BENCH["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    return out


@pytest.mark.parametrize("name", _all_names())
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_units_and_keys(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert set(metric) <= METRIC_KEYS
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= LAYER_KEYS
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["layer"] and "\n" not in metric["layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "splatbench/run.py"]
    assert BENCH["paths"] == ["splatbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    with open(os.path.join(REPO, "BENCHMARK.json"), "rb") as fh:
        assert len(fh.read()) <= 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_and_reports_what_it_must(cell):
    bench_dir = os.path.join(REPO, "splatbench")
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    cfg = json.load(open(os.path.join(bench_dir, "configs", cell["config"] + ".json")))
    assert cfg["name"] == cell["config"]
    traffic = json.load(open(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json")))
    assert os.path.exists(os.path.join(bench_dir, "drivers", traffic["driver"] + ".py"))
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_a_metric_its_cells_report(metric):
    assert os.path.exists(os.path.join(REPO, "splatbench", "metrics", metric["name"] + ".py"))
    for cell in metric["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert metric["moves"] in e2e, (metric["name"], cell)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries_match_their_files(cfg):
    assert cfg["file"] == f"splatbench/configs/{cfg['name']}.json"
    data = json.load(open(os.path.join(REPO, cfg["file"])))
    assert data["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
