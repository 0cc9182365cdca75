"""The harness imports the PyTorch/CUDA package and nothing else of the
repository; the reference imports nothing of the package; nothing imports
JAX or the JAX package (top-level names compared whole)."""

from __future__ import annotations

import ast
import os

import pytest

from conftest import REPO

BENCH_DIR = os.path.join(REPO, "splatbench")
PORT = "gaussiansplattingregistration_tpu_torch"
BANNED = {"jax", "jaxlib", "flax", "gaussiansplattingregistration_tpu", "bench_torch",
          "chip_smoke", "scripts", "bench", "tests"}


def _sources(sub=""):
    out = []
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        if os.sep + "tests" in d[len(BENCH_DIR):]:
            continue
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_harness_imports_only_the_port_of_this_repository(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in BANNED, (path, name)


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_reference_imports_nothing_of_the_port(path):
    for name in _imports(path):
        assert name.split(".")[0] != PORT, (path, name)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys

    from splatbench import run

    monkeypatch.setitem(sys.modules, PORT + ".ops", sys.modules.get("os"))
    assert "gaussiansplattingregistration_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gaussiansplattingregistration_tpu.ops", sys.modules["os"])
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["os"])
    assert {"gaussiansplattingregistration_tpu", "jax"} <= set(run.forbidden_modules())
