"""The photometric cell: its readers of the program's spans
(`metrics/photo_*.py`): the division by the traced steps on a fabricated
snapshot, None where the run has no device trace, where a span is missing
and where the program has no snapshot (a version before the refiner's
spans); a step whose update is broken comes out not correct; jobs that end
in the window are held to the truth; `drivers/photometric.py::work` is the
sum of its traced views'. On a card: the tiny cell's traced run reports
every metric of the cell, and its check is `correct`."""

from __future__ import annotations

import importlib.util
import json
import os

import pytest
import torch

from conftest import REPO, _merge, make_checkout, run_cell
from test_splatbench_faults import _run_in_process

from gaussiansplattingregistration_tpu_torch.pipelines import photometric as port_photo
from gaussiansplattingregistration_tpu_torch.utils import profiling

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
PHOTO = {"photo_loss_device_ms", "photo_render_vjp_device_ms", "photo_pose_device_ms",
         "photo_step_host_ms"}


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name, os.path.join(REPO, "splatbench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(count, host_s, device_s):
    return {"count": count, "host_s": host_s, "self_host_s": host_s / 2, "device_s": device_s}


SNAPSHOT = {
    "spans": {"photometric.step": span(2, 1.2, 1.0), "photometric.pose": span(16, 0.02, 0.004),
              "photometric.merge": span(16, 0.01, 0.006),
              "photometric.adam": span(2, 0.002, 0.002),
              "photometric.loss": span(16, 0.03, 0.02), "photometric.loss_vjp": span(16, 0.02, 0.03),
              "photometric.render_vjp": span(16, 0.4, 0.5), "metrics.ssim": span(16, 0.01, 0.01)},
    "counters": {"photometric.views": 16}, "unresolved": {}, "dropped": 0}

# (value on SNAPSHOT over 2 traced steps)
EXPECTED = {"photo_loss_device_ms": 25.0, "photo_render_vjp_device_ms": 250.0,
            "photo_pose_device_ms": 6.0, "photo_step_host_ms": 600.0}


def rec(steps, trace=True):
    return {"trace": {"busy_s": 1.0, "window_s": 2.0, "kernels": {}} if trace else {},
            "traffic": {"trace_steps": steps}, "spans": {}}


def test_the_four_entries_are_declared_for_the_cell():
    entries = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in PHOTO}
    assert set(entries) == PHOTO == set(EXPECTED)
    for m in entries.values():
        assert m["workloads"] == ["photo_pair_step"] and m["layer"] == "photometric"
        assert m["moves"] == "fwd_bwd_pixels_per_s" and m["source"] == "program_span"


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_divides_by_the_traced_steps(monkeypatch, name):
    monkeypatch.setattr(profiling, "snapshot", lambda: json.loads(json.dumps(SNAPSHOT)))
    assert reader(name)(rec(2)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_finds_nothing_without_a_trace_or_its_span(monkeypatch, name):
    monkeypatch.setattr(profiling, "snapshot", lambda: json.loads(json.dumps(SNAPSHOT)))
    assert reader(name)(rec(2, trace=False)) is None
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": {}, "counters": {}, "unresolved": {}, "dropped": 0})
    assert reader(name)(rec(2)) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert reader(name)(rec(2)) is None


# ------------------------------------------------ a broken step's update


def _update_left_out(restart):
    """Adam steps, then `xi` is put back as it was."""
    def fn(self, *a, **k):
        restart(self, *a, **k)
        step = self.opt.step

        def no_update(*sa, **sk):
            before = self.xi.detach().clone()
            step(*sa, **sk)
            with torch.no_grad():
                self.xi.copy_(before)
        self.opt.step = no_update
    return fn


def _lr_doubled(restart):
    def fn(self, *a, **k):
        restart(self, *a, **k)
        self.opt.param_groups[0]["lr"] *= 2.0
    return fn


def _view_dropped(camera_loss):
    """The gradient is zeroed inside the view loop, so the update sees
    the last view's alone."""
    def fn(self, *a, **k):
        self.opt.zero_grad(set_to_none=True)
        return camera_loss(self, *a, **k)
    return fn


UPDATE_FAULTS = {"update_left_out": ("restart", _update_left_out, {"adam_step_gap_per_lr"}),
                 "lr_doubled": ("restart", _lr_doubled, {"adam_step_gap_per_lr"}),
                 "view_dropped": ("_camera_loss", _view_dropped, {"grad_sum_rel_gap"})}


@pytest.mark.parametrize("fault", sorted(UPDATE_FAULTS))
def test_a_broken_update_is_not_correct(checkout, monkeypatch, fault):
    name, wrap, fails = UPDATE_FAULTS[fault]
    monkeypatch.setattr(port_photo.PhotometricRefiner, name,
                        wrap(getattr(port_photo.PhotometricRefiner, name)))
    line = _run_in_process(checkout, "tiny_photo_pair_step")
    assert line["correct"] is False, line["compared"]
    failed = {k for k, c in line["compared"].items()
              if (c["value"] > c["limit"]) == (c["fails_if"] == "above")}
    assert failed == fails, line["compared"]


def test_jobs_that_end_in_the_window_are_held_to_the_truth(tmp_path):
    """Jobs of 2 steps on the tiny stand-in (a test traffic of its own),
    each end pose held no farther from the truth than the 1 degree and
    0.02 it started from, since 2 steps do not reach the stated 0.25 and
    0.005."""
    root = make_checkout(str(tmp_path))
    bench_dir = os.path.join(root, "splatbench")
    with open(os.path.join(bench_dir, "traffic", "photo_steps_8view.json")) as fh:
        mix = json.load(fh)
    with open(os.path.join(bench_dir, "traffic", "photo_steps_short.json"), "w") as fh:
        json.dump({**mix, "steps_per_job": 2, "warmup_steps": 1}, fh)
    with open(os.path.join(bench_dir, "configs", "tiny_photo_pair.json")) as fh:
        cfg = json.load(fh)
    cfg = _merge(cfg, {"name": "tiny_photo_short", "stated_limits": {
        "truth_rot_err_deg": ["max", 1.0], "truth_trans_err": ["max", 0.02]}})
    with open(os.path.join(bench_dir, "configs", "tiny_photo_short.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": "tiny_photo_short", "config": "tiny_photo_short",
                               "traffic": "photo_steps_short", "chips": 1, "why": "a test cell"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "fwd_bwd_pixels_per_s")["workloads"].append("tiny_photo_short")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    rc, line, err = run_cell(root, "tiny_photo_short", seconds=3.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    assert line["reported"]["jobs_completed"] >= 1, err[-3000:]
    assert line["compared"]["truth_rot_err_deg"]["value"] > 0
    assert line["compared"]["truth_trans_err"]["value"] > 0


def test_the_roofline_work_sums_every_view_of_each_traced_step(monkeypatch):
    """`work` counts each traced step's views at the step's own `xi`."""
    from splatbench import common
    from splatbench.drivers import photometric as drv
    from splatbench.reference import photometric as ref
    from splatbench.roofline import composite as roofline

    with open(os.path.join(REPO, "splatbench", "configs", "photo_pair1m_sh3_1557.json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(REPO, "splatbench", "tests", "tiny",
                           "photo_pair1m_sh3_1557.json")) as fh:
        cfg = _merge(cfg, json.load(fh)["overrides"])
    with open(os.path.join(REPO, "splatbench", "traffic", "photo_steps_8view.json")) as fh:
        mix = {**json.load(fh), "warmup_steps": 0}
    ctx = common.Context(cell={"name": "tiny"}, config=cfg, traffic=mix,
                         device=torch.device("cpu"), seed=5, control=None)
    st = drv.setup(ctx)
    counted = []
    monkeypatch.setattr(roofline, "bound_s", lambda cost, card: counted.append(cost) or 1.0)
    assert drv.work(st, {"fp32_flops": 1.0, "hbm_bytes_per_s": 1.0}) == {}
    drv.traced_step(st, 0)
    drv.traced_step(st, 1)
    assert not torch.equal(st.traced[0][1], st.traced[1][1])
    got = drv.work(st, {"fp32_flops": 1.0, "hbm_bytes_per_s": 1.0})
    assert got == {"composite_fwd": 4.0, "composite_bwd": 4.0}     # 2 steps x 2 views
    posed = ref.posed_arrays(st.traced[1][1], torch.eye(4), drv.arrays(st.moving[0]), st.fixed)
    vm, intr = st.views[1]
    w = roofline.frame_work(posed[0], posed[1], posed[2], vm, intr, st.width, st.height,
                            st.ref_params)
    assert counted[-2:] == [roofline.forward_cost(w), roofline.backward_cost(w)]


@pytest.mark.card
def test_a_traced_tiny_run_on_the_card_reports_every_metric(card, checkout):
    rc, line, err = run_cell(checkout, "tiny_photo_pair_step", trace=1, device="cuda")
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    declared = {m["name"] for m in BENCH["per_layer"]
                if "photo_pair_step" in m.get("workloads", [])}
    assert PHOTO < declared and declared <= set(got), got
    assert all(got[k] > 0 for k in PHOTO), got
    assert all(0 < got[k] <= 105 for k in got if "roofline" in k), got
