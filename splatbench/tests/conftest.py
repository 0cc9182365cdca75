"""Fixtures of the benchmark's CPU tests: a checkout in a temporary
directory that holds the benchmark and tiny cells of its own, added as new
files (configurations, cells), and a runner of `run.py` in a subprocess.

    python -m pytest splatbench/tests -q      # from the repository root

Tests that need a card carry the `card` marker and skip without one."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Tiny stand-ins of the two configurations: the same keys and widths, a
# small scene, so a CPU run takes seconds.
TINY_CONFIGS = {
    "tiny_splat": ("splat1m_sh3_720p", {"scene": {"splats": 1000, "scale_range": [0.04, 0.08]},
                                        "camera": {"width": 64, "height": 48},
                                        "rasterizer": {"max_splats_per_tile": 1024,
                                                       "max_live_tiles": None}}),
    "tiny_reg": ("reg200k_sh3", {"splats": 4000}),
}


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
    tests), plus the tiny configurations and a tiny cell beside each cell,
    all as new files and entries. Returns `root`."""
    shutil.copytree(os.path.join(REPO, "splatbench"), os.path.join(root, "splatbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for name, (base, over) in TINY_CONFIGS.items():
        with open(os.path.join(REPO, "splatbench", "configs", base + ".json")) as fh:
            cfg = _merge(json.load(fh), over)
        cfg["name"] = name
        with open(os.path.join(root, "splatbench", "configs", name + ".json"), "w") as fh:
            json.dump(cfg, fh)
    tiny_of = {"splat1m_sh3_720p": "tiny_splat", "reg200k_sh3": "tiny_reg"}
    for w in list(bench["workloads"]):
        bench["workloads"].append({**w, "name": "tiny_" + w["name"], "config": tiny_of[w["config"]]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + ["tiny_" + w for w in m["workloads"]]
    # The voxel jobs have no cell of their own yet; a tiny one runs them.
    bench["workloads"].append({"name": "tiny_reg200k_voxel", "config": "tiny_reg",
                               "traffic": "voxel_jobs", "chips": 1, "why": "a test cell"})
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
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
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
