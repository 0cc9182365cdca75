"""The reader of `knn_kernel_pair_share`: the program's `knn.kernel_pairs`
over its `knn.pairs` on a fabricated snapshot, and None where the run has
no device trace, where the program counts no kernel pairs (a version of it
without the kNN kernel) and where it has no snapshot."""

from __future__ import annotations

import importlib.util
import os

import pytest

from conftest import REPO

from gaussiansplattingregistration_tpu_torch.utils import profiling


def read(rec):
    spec = importlib.util.spec_from_file_location(
        "metric_knn_kernel_pair_share",
        os.path.join(REPO, "splatbench", "metrics", "knn_kernel_pair_share.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def rec(trace=True):
    return {"trace": {"busy_s": 1.0, "window_s": 2.0, "kernels": {}} if trace else {},
            "traffic": {"trace_steps": 2}, "spans": {}}


def snapshot(counters):
    return lambda: {"spans": {}, "counters": dict(counters), "unresolved": {}, "dropped": 0}


@pytest.mark.parametrize("counters, want", [
    ({"knn.pairs": 2.0e9, "knn.kernel_pairs": 2.0e9}, 1.0),
    ({"knn.pairs": 2.0e9, "knn.kernel_pairs": 1.5e9}, 0.75),
])
def test_the_share_of_kernel_pairs(monkeypatch, counters, want):
    monkeypatch.setattr(profiling, "snapshot", snapshot(counters))
    assert read(rec()) == pytest.approx(want)


def test_nothing_to_read(monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", snapshot({"knn.pairs": 2.0e9}))
    assert read(rec()) is None                    # no kernel in the program
    monkeypatch.setattr(profiling, "snapshot", snapshot({"knn.kernel_pairs": 1.0}))
    assert read(rec()) is None                    # no search counted
    monkeypatch.setattr(profiling, "snapshot",
                        snapshot({"knn.pairs": 2.0e9, "knn.kernel_pairs": 2.0e9}))
    assert read(rec(trace=False)) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read(rec()) is None
