"""Each cell runs end to end at a tiny size on the CPU and prints the
contract's last line; a new cell, and a new configuration with its tiny
stand-in, need only new files and appended entries; without a card the
harness exits non-zero and prints nothing; in a directory without the
package it fails."""

from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, REPO, make_checkout, run_cell, tiny_cells, tiny_stand_in

# A cell whose configuration has no tiny stand-in is left out here;
# `test_every_configuration_has_a_tiny_stand_in` names it.
CELLS = tiny_cells()


def _load_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), os.path.join(REPO, "splatbench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    # metrics are there.
    assert set(line["metrics"]) == {"render_p50_ms", "render_p95_ms.view"}
    assert line["metrics"]["render_p95_ms.view"]["value"] >= line["metrics"]["render_p50_ms"]["value"]


def test_the_view_cell_reports_its_mean_render_over_the_whole_window(checkout):
    rc, line, err = run_cell(checkout, "tiny_splat1m_view")
    assert rc == 0, err[-3000:]
    steps, window_s = re.search(r"# window: (\d+) steps in ([0-9.e-]+) s", err).groups()
    assert line["attempted"] == int(steps)
    assert line["metrics"]["render_mean_ms"]["value"] == pytest.approx(
        1e3 * float(window_s) / int(steps), rel=1e-9)


def test_the_p95_reader_takes_the_tail_of_every_render():
    reader = _load_reader("render_p95_ms.view")
    renders = [i * 1e-3 for i in range(1, 101)]
    assert reader.read({"spans": {"render": renders}}) == pytest.approx(95.05)
    assert reader.read({"spans": {}}) is None


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
        if m["name"] == "render_mean_ms":
            m["workloads"].append("tiny_new")
    bench["per_layer"].append({"name": "renders_timed", "unit": "renders", "better": "higher",
                               "source": "host_clock", "layer": "rasterizer stages",
                               "moves": "render_mean_ms", "workloads": ["tiny_new"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    rc, line, err = run_cell(root, "tiny_new", trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-1500:]
    assert line["metrics"]["renders_timed"]["value"] > 0


def test_a_new_configuration_needs_only_new_files(tmp_path):
    """A copy of the benchmark, its tests included, takes a new
    configuration, its tiny stand-in, a cell on it and a per-layer metric
    as new files and appended entries, and its own tests pass there."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "splatbench"), os.path.join(root, "splatbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    bench_dir = os.path.join(root, "splatbench")

    def write_new(rel, data):   # a file the copy does not have yet
        path = os.path.join(bench_dir, rel)
        assert not os.path.exists(path), rel
        with open(path, "w") as fh:
            fh.write(data if isinstance(data, str) else json.dumps(data, indent=1))

    with open(os.path.join(bench_dir, "configs", "splat1m_sh3_720p.json")) as fh:
        cfg = json.load(fh)
    write_new("configs/splat_copy.json", {**cfg, "name": "splat_copy"})
    with open(os.path.join(bench_dir, "tests", "tiny", "splat1m_sh3_720p.json")) as fh:
        tiny = json.load(fh)
    write_new("tests/tiny/splat_copy.json", {**tiny, "name": "tiny_splat_copy"})
    write_new("metrics/renders_in_window.py",
              '"""Renders timed in the window."""\n\n\ndef read(rec):\n'
              '    return float(rec["steps"]) or None\n')
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    source = next(c for c in bench["configs"] if c["name"] == "splat1m_sh3_720p")
    bench["configs"].append({**source, "name": "splat_copy",
                             "file": "splatbench/configs/splat_copy.json"})
    bench["workloads"].append({"name": "splat_copy_view", "config": "splat_copy",
                               "traffic": "render_3yaw", "chips": 1, "why": "a test cell"})
    next(m for m in bench["end_to_end"] if m["name"] == "render_mean_ms")["workloads"].append(
        "splat_copy_view")
    bench["per_layer"].append({"name": "renders_in_window", "unit": "renders",
                               "better": "higher", "source": "host_clock",
                               "layer": "rasterizer stages", "moves": "render_mean_ms",
                               "workloads": ["splat_copy_view"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh, indent=1)

    path = [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    tests = os.path.join("splatbench", "tests")
    # A configuration of this tree without a stand-in already fails its own
    # test in this run; the copy's run leaves that test out.
    deselect = [arg for c in BENCH["configs"] if tiny_stand_in(c["name"]) is None
                for arg in ("--deselect", os.path.join(tests, "test_splatbench_manifest.py")
                            + f"::test_every_configuration_has_a_tiny_stand_in[{c['name']}]")]
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-m", "not card", "-p", "no:cacheprovider",
         *deselect, os.path.join(tests, "test_splatbench_manifest.py"),
         os.path.join(tests, "test_splatbench_program_spans.py"),
         os.path.join(tests, "test_splatbench_cells.py") + "::test_each_cell_runs_at_a_tiny_size"],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    passed = [ln for ln in proc.stdout.splitlines() if ln.startswith("PASSED")]
    assert any("test_each_cell_runs_at_a_tiny_size[splat_copy_view]" in ln for ln in passed), \
        proc.stdout[-4000:]
    assert any("test_every_configuration_has_a_tiny_stand_in[splat_copy]" in ln
               for ln in passed), proc.stdout[-4000:]


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
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "splatbench/run.py", "--workload", "splat1m_view",
                           "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                          cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()
