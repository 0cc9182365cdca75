"""Each cell runs end to end at a tiny size on the CPU and prints the
contract's last line; a new cell needs only new files; without a card the
harness exits non-zero and prints nothing; in a directory without the
package it fails."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from conftest import REPO, make_checkout, run_cell

CELLS = [w["name"] for w in json.load(open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]


def _valid_line(line: dict, trace: int):
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "compared"
    assert line["attempted"] > 0 and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    for c in line["compared"].values():
        assert set(c) == {"value", "limit", "fails_if"}


@pytest.mark.parametrize("cell", CELLS + ["reg200k_voxel"])
def test_each_cell_runs_at_a_tiny_size(checkout, cell):
    rc, line, err = run_cell(checkout, "tiny_" + cell)
    assert rc == 0, err[-3000:]
    _valid_line(line, 0)
    assert line["correct"] is True, err[-3000:]
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    # The numbers compared are the last lines of standard error.
    tail = [ln for ln in err.strip().splitlines()][-len(line["compared"]):]
    assert all(ln.startswith("# compared: ") for ln in tail)


def test_a_traced_run_reports_span_metrics(checkout):
    rc, line, err = run_cell(checkout, "tiny_splat1m_view", trace=1)
    assert rc == 0, err[-3000:]
    _valid_line(line, 1)
    # On the CPU no device operation is traced, so only the host span
    # metric is there.
    assert set(line["metrics"]) == {"render_p50_ms"}


def test_a_new_cell_needs_only_new_files(tmp_path):
    root = make_checkout(str(tmp_path))
    bench_dir = os.path.join(root, "splatbench")
    with open(os.path.join(bench_dir, "traffic", "render_3yaw.json")) as fh:
        mix = json.load(fh)
    mix["yaws"] = [0.2, -0.1]
    with open(os.path.join(bench_dir, "traffic", "render_2yaw_new.json"), "w") as fh:
        json.dump(mix, fh)
    shutil.copy(os.path.join(bench_dir, "configs", "tiny_splat.json"),
                os.path.join(bench_dir, "configs", "tiny_splat_new.json"))
    with open(os.path.join(bench_dir, "configs", "tiny_splat_new.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "tiny_splat_new"
    with open(os.path.join(bench_dir, "configs", "tiny_splat_new.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench_dir, "metrics", "renders_timed.py"), "w") as fh:
        fh.write('"""Renders timed in the window."""\n\n\ndef read(rec):\n'
                 '    return float(len(rec["spans"].get("render", []))) or None\n')
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": "tiny_new", "config": "tiny_splat_new",
                               "traffic": "render_2yaw_new", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "render_p95_ms":
            m["workloads"].append("tiny_new")
    bench["per_layer"].append({"name": "renders_timed", "unit": "renders", "better": "higher",
                               "source": "host_clock", "layer": "rasterizer stages",
                               "moves": "render_p95_ms", "workloads": ["tiny_new"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    rc, line, err = run_cell(root, "tiny_new", trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-1500:]
    assert line["metrics"]["renders_timed"]["value"] > 0


def test_without_a_card_it_exits_nonzero_and_prints_no_result(checkout):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, line, err = run_cell(checkout, "tiny_splat1m_view", device=None)
    assert rc != 0 and line is None and "no CUDA device" in err


def test_without_the_package_it_fails(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "splatbench"), os.path.join(root, "splatbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "splatbench/run.py", "--workload", "splat1m_view",
                           "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                          cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()
