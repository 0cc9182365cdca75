"""The readers of the program's own spans and counters
(`splatbench/program_spans.py` and the metrics that use it): the division
by the traced steps on a fabricated snapshot, None where the run has no
device trace, where a span is missing and where the program has no
snapshot; their entries declared by name, and every reader declared. On a
card: each tiny cell's traced run reports its new metrics, and tracing
adds no synchronize to a frame or a registration job."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import warnings

import pytest
import torch

from conftest import REPO, run_cell

from gaussiansplattingregistration_tpu_torch.utils import profiling

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NEW = {"hem_device_s", "multiscale_device_s", "knn_device_s", "knn_gpairs_per_s",
       "normals_device_s", "icp_iterations", "raster_host_ms.view", "raster_host_ms.train",
       "bin_device_ms.view", "bin_device_ms.train", "gather_vjp_device_ms.train"}


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), os.path.join(REPO, "splatbench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(count, host_s, device_s):
    return {"count": count, "host_s": host_s, "self_host_s": host_s / 2, "device_s": device_s}


SNAPSHOT = {
    "spans": {"hem.create_mixture": span(1, 0.8, 0.6), "multiscale.register": span(1, 1.2, 1.1),
              "knn.knn": span(9, 0.5, 0.4), "knn.nearest": span(60, 0.7, 0.5),
              "knn.grid_topk": span(2, 0.2, 0.1), "normals.estimate": span(6, 0.3, 0.25),
              "raster.frame": span(6, 0.030, 0.024), "raster.bin": span(6, 0.006, 0.0048),
              "raster.gather_vjp": span(6, 0.012, 0.009),
              "raster.composite_vjp": span(6, 0.003, 0.0054)},
    "counters": {"knn.pairs": 2.0e9, "icp.iterations": 60},
    "unresolved": {}, "dropped": 0}

# (reader, traced steps, value on SNAPSHOT)
EXPECTED = {
    "hem_device_s": (2, 0.3), "multiscale_device_s": (2, 0.55), "knn_device_s": (2, 0.5),
    "knn_gpairs_per_s": (2, 2.0), "normals_device_s": (2, 0.125), "icp_iterations": (2, 30.0),
    "raster_host_ms.view": (6, 5.0), "raster_host_ms.train": (6, 7.5),
    "bin_device_ms.view": (6, 0.8), "bin_device_ms.train": (6, 0.8),
    "gather_vjp_device_ms.train": (6, 1.5)}


def rec(steps, trace=True):
    return {"trace": {"busy_s": 1.0, "window_s": 2.0, "kernels": {}} if trace else {},
            "traffic": {"trace_steps": steps}, "spans": {}}


def test_the_new_entries_are_declared_and_complete():
    # By name, wherever they sit in `per_layer`: later entries may follow.
    names = {m["name"] for m in BENCH["per_layer"]}
    assert NEW <= names and NEW == set(EXPECTED)


def test_every_entry_has_its_reader_and_every_reader_is_an_entry():
    names = {m["name"] for m in BENCH["per_layer"]}
    metrics = os.path.join(REPO, "splatbench", "metrics")
    readers = {f[:-len(".py")] for f in os.listdir(metrics) if f.endswith(".py")}
    assert names == readers, {"without a reader": sorted(names - readers),
                              "not declared": sorted(readers - names)}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_divides_by_the_traced_steps(monkeypatch, name):
    monkeypatch.setattr(profiling, "snapshot", lambda: json.loads(json.dumps(SNAPSHOT)))
    steps, want = EXPECTED[name]
    assert reader(name)(rec(steps)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_finds_nothing_without_a_trace_or_its_span(monkeypatch, name):
    monkeypatch.setattr(profiling, "snapshot", lambda: json.loads(json.dumps(SNAPSHOT)))
    assert reader(name)(rec(2, trace=False)) is None
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": {}, "counters": {}, "unresolved": {}, "dropped": 0})
    assert reader(name)(rec(2)) is None
    # A program without the tracing module's snapshot (a version before it).
    monkeypatch.delattr(profiling, "snapshot")
    assert reader(name)(rec(2)) is None


def test_device_readers_refuse_unresolved_or_dropped_intervals(monkeypatch):
    snap = json.loads(json.dumps(SNAPSHOT))
    snap["unresolved"] = {"knn.nearest": 1}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    assert reader("knn_device_s")(rec(1)) is None
    assert reader("hem_device_s")(rec(1)) == pytest.approx(0.6)
    snap["unresolved"], snap["dropped"] = {}, 3
    assert reader("hem_device_s")(rec(1)) is None
    assert reader("icp_iterations")(rec(1)) == 60.0


# ------------------------------------------------------------------- on a card

CELL_METRICS = {
    cell: {m["name"] for m in BENCH["per_layer"] if m["name"] in NEW and cell in m["workloads"]}
    for cell in ("splat1m_train", "splat1m_view", "reg200k_hem")}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELL_METRICS))
def test_a_traced_tiny_run_on_the_card_reports_the_new_metrics(card, checkout, cell):
    rc, line, err = run_cell(checkout, "tiny_" + cell, trace=1, device="cuda")
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert CELL_METRICS[cell] <= set(got), (cell, got)
    assert all(got[k] > 0 for k in CELL_METRICS[cell]), got


def _syncs(fn) -> int:
    """The synchronizing CUDA calls `fn` makes, as sync debug mode counts them."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def _driver_state(checkout, config: str, traffic: str, device):
    from splatbench import common

    bench = os.path.join(checkout, "splatbench")
    tr = common.load_json(bench, "traffic", traffic + ".json")
    name = "splatbench_driver_" + tr["driver"]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(bench, "drivers", tr["driver"] + ".py"))
    driver = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    ctx = common.Context(cell={"name": "tiny"}, config=common.load_json(bench, "configs",
                                                                        config + ".json"),
                         traffic=tr, device=device, seed=3_000_000_019)
    return driver, driver.setup(ctx)


@pytest.mark.card
def test_tracing_adds_no_synchronize(card, checkout):
    from gaussiansplattingregistration_tpu_torch.ops import rasterize as port_raster

    _, view = _driver_state(checkout, "tiny_splat", "render_3yaw", card)
    train_driver, train = _driver_state(checkout, "tiny_splat", "fwd_bwd_3yaw", card)
    reg_driver, reg = _driver_state(checkout, "tiny_reg", "hem_jobs", card)
    vm, intr = view.views[0]
    bg = torch.zeros(3, device=card)

    def render():
        with torch.no_grad():
            port_raster.rasterize_arrays(*view.scene, vm, intr, view.width, view.height,
                                         view.sh_degree, bg, view.port_config, device=card)

    paths = {"render": render, "train_frame": lambda: train_driver.step(train, 0),
             "registration_job": lambda: reg_driver.step(reg, 0)}
    counts = {}
    for name, fn in paths.items():
        off = _syncs(fn)
        profiling.reset()
        with profiling.recording():
            on = _syncs(fn)
        assert profiling.snapshot()["spans"], name
        counts[name] = (off, on)
    assert all(off == on for off, on in counts.values()), counts
    assert counts["registration_job"][0] > 0, counts     # the count sees them
    # The port synchronizes on its own (a host scalar written into a device
    # tensor in the projection, boolean masks, the ICP stop test), so the
    # paths above compare counts; the snapshot itself runs with every
    # synchronize made an error.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        snap = profiling.snapshot()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert snap["unresolved"] == {} and snap["spans"]["hem.create_mixture"]["device_s"] > 0
