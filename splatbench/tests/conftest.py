"""Fixtures of the benchmark's CPU tests: a checkout in a temporary
directory that holds the benchmark and tiny cells of its own, added as new
files (configurations, cells), and a runner of `run.py` in a subprocess.

Each configuration of BENCHMARK.json has a tiny stand-in in
`tiny/<configuration>.json`: the stand-in's `name` and the keys it
`overrides`, merged over `configs/<configuration>.json`. Each cell gets a
tiny cell `tiny_<cell>` on its configuration's stand-in.

    python -m pytest splatbench/tests -q      # from the repository root

Tests that need a card carry the `card` marker and skip without one."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
TINY = os.path.join(HERE, "tiny")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

with open(os.path.join(REPO, "BENCHMARK.json")) as _fh:
    BENCH = json.load(_fh)


def tiny_stand_in(config: str):
    """(name, overrides) of a configuration's tiny stand-in, from
    `tiny/<config>.json`; None where the configuration has none."""
    path = os.path.join(TINY, config + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        tiny = json.load(fh)
    return tiny["name"], tiny["overrides"]


def tiny_cells() -> list:
    """The cells of BENCHMARK.json whose configuration has a tiny stand-in."""
    return [w["name"] for w in BENCH["workloads"] if tiny_stand_in(w["config"]) is not None]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card's machine)")
    return torch.device("cuda")


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def make_checkout(root: str) -> str:
    """A checkout at `root`: BENCHMARK.json and splatbench/ (without its
    tests), plus each configuration's tiny stand-in and a tiny cell beside
    each cell, all as new files and entries. A configuration without a
    stand-in has no tiny cells (`test_every_configuration_has_a_tiny_stand_in`
    names it). Returns `root`."""
    shutil.copytree(os.path.join(REPO, "splatbench"), os.path.join(root, "splatbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    tiny_of = {}
    for config in bench["configs"]:
        stand_in = tiny_stand_in(config["name"])
        if stand_in is None:
            continue
        name, over = stand_in
        with open(os.path.join(REPO, config["file"])) as fh:
            cfg = _merge(json.load(fh), over)
        cfg["name"] = name
        with open(os.path.join(root, "splatbench", "configs", name + ".json"), "w") as fh:
            json.dump(cfg, fh)
        tiny_of[config["name"]] = name
    tiny = [{**w, "name": "tiny_" + w["name"], "config": tiny_of[w["config"]]}
            for w in bench["workloads"] if w["config"] in tiny_of]
    bench["workloads"] += tiny
    made = {w["name"] for w in tiny}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + ["tiny_" + w for w in m["workloads"]
                                               if "tiny_" + w in made]
    # The voxel jobs have no cell of their own yet; a tiny one beside the
    # HEM cell runs them.
    if "tiny_reg200k_hem" in made:
        hem = next(w for w in tiny if w["name"] == "tiny_reg200k_hem")
        bench["workloads"].append({**hem, "name": "tiny_reg200k_voxel", "traffic": "voxel_jobs",
                                   "why": "a test cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "tiny_reg200k_hem" in m.get("workloads", []) and m["name"] != "hem_s":
                m["workloads"].append("tiny_reg200k_voxel")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh, indent=1)
    return root


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))


def run_cell(root: str, workload: str, *extra, seed: int = 3_000_000_019, seconds: float = 1.0,
             trace: int = 0, device: str = "cpu", timeout: int = 600):
    """(return code, the last stdout line parsed or None, stderr) of one run."""
    # The package comes from REPO, or from PYTHONPATH where REPO is a copy
    # of the benchmark alone.
    path = [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path), OMP_NUM_THREADS="2")
    cmd = [sys.executable, os.path.join(root, "splatbench", "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    if device:
        cmd += ["--device", device]
    proc = subprocess.run(cmd + list(extra), cwd=root, env=env, capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return proc.returncode, last, proc.stderr
