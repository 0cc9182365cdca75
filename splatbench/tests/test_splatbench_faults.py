"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (`--device cpu`) and the rest of a run
is driven, once for each fault a cell can have. One chip per cell, so no
cell has an exchange between chips to leave out.

The control (the lower precision in the program's place) is held here
too: the program's own bf16 cotangent transport on the CPU, and TF32 on a
card."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from conftest import run_cell

import gaussiansplattingregistration_tpu_torch.ops.hem as port_hem
import gaussiansplattingregistration_tpu_torch.ops.rasterize as port_raster
import gaussiansplattingregistration_tpu_torch.pipelines.multiscale as port_ms


def _run_in_process(root: str, workload: str, seconds: float = 1.0) -> dict:
    spec = importlib.util.spec_from_file_location("splatbench_run_under_test",
                                                  os.path.join(root, "splatbench", "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", "2900000003", "--seconds", str(seconds),
                       "--trace", "0", "--device", "cpu"])
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


# ------------------------------------------------------------- render cells


def _altered(orig):
    def fn(*a, **k):
        rgb, alpha, depth = orig(*a, **k)
        rgb = rgb + torch.zeros_like(rgb).index_put_((torch.tensor([0]),) * 3, torch.tensor(0.5))
        return rgb, alpha, depth
    return fn


def _half_left_out(orig):
    def fn(*a, **k):
        rgb, alpha, depth = orig(*a, **k)
        keep = (torch.arange(rgb.shape[0]) < rgb.shape[0] // 2).to(rgb.dtype)
        return rgb * keep[:, None, None], alpha * keep[:, None], depth * keep[:, None]
    return fn


def _state_unchanged(orig):
    first = {}

    def fn(means, cov, op, feats, viewmat, *rest, **k):
        first.setdefault("viewmat", viewmat)
        return orig(means, cov, op, feats, first["viewmat"], *rest, **k)
    return fn


RENDER_FAULTS = {"answer_altered": _altered, "half_left_out": _half_left_out,
                 "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("cell", ["tiny_splat1m_train", "tiny_splat1m_view"])
@pytest.mark.parametrize("fault", sorted(RENDER_FAULTS))
def test_a_broken_render_is_not_correct(checkout, monkeypatch, cell, fault):
    monkeypatch.setattr(port_raster, "rasterize_arrays",
                        RENDER_FAULTS[fault](port_raster.rasterize_arrays))
    line = _run_in_process(checkout, cell)
    assert line["correct"] is False, line["compared"]


# ------------------------------------------- faults of the backward pass alone


class _GradMask(torch.autograd.Function):
    """The identity forward; the backward keeps the cotangent's rows where
    `keep` is true and zeroes the rest."""

    @staticmethod
    def forward(ctx, x, keep):
        ctx.save_for_backward(keep)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (keep,) = ctx.saved_tensors
        return g * keep.reshape(keep.shape + (1,) * (g.dim() - keep.dim())).to(g.dtype), None


def _cotangent_half_left_out(orig):
    """The image's lower half of the cotangent is left out."""
    def fn(*a, **k):
        rgb, alpha, depth = orig(*a, **k)
        keep = torch.arange(rgb.shape[0]) < rgb.shape[0] // 2
        return _GradMask.apply(rgb, keep), alpha, depth
    return fn


def _splat_grads_dropped(pick):
    """The gradients of the splats `pick` chooses are dropped."""
    def wrap(orig):
        def fn(means, cov, op, feats, viewmat, intr, width, height, *rest, **k):
            keep = ~pick(means, cov, viewmat, intr, width, height)
            args = [_GradMask.apply(x, keep) for x in (means, cov, op, feats)]
            return orig(*args, viewmat, intr, width, height, *rest, **k)
        return fn
    return wrap


def _multi_tile(means, cov, viewmat, intr, width, height):
    """Splats whose footprint, by the reference's projection, spans more
    than one 16-pixel tile."""
    from splatbench.reference import raster

    cfg = json.load(open(os.path.join(os.path.dirname(__file__), "..", "configs",
                                      "splat1m_sh3_720p.json")))
    pr = raster.project(means.detach(), cov.detach(), viewmat, intr, width, height,
                        raster.RasterParams.from_config(cfg["rasterizer"]))
    ts = cfg["rasterizer"]["tile_size"]
    lo = torch.floor((pr["means2d"] - pr["radius"][:, None]) / ts)
    hi = torch.floor((pr["means2d"] + pr["radius"][:, None]) / ts)
    return pr["valid"] & (hi > lo).any(dim=1)


def _one_in_ten(means, *_):
    return torch.arange(means.shape[0]) % 10 == 3


BACKWARD_FAULTS = {"cotangent_half_left_out": _cotangent_half_left_out,
                   "multi_tile_grads_dropped": _splat_grads_dropped(_multi_tile),
                   "one_splat_in_ten_dropped": _splat_grads_dropped(_one_in_ten)}


@pytest.mark.parametrize("fault", sorted(BACKWARD_FAULTS))
def test_a_broken_backward_is_not_correct(checkout, monkeypatch, fault):
    monkeypatch.setattr(port_raster, "rasterize_arrays",
                        BACKWARD_FAULTS[fault](port_raster.rasterize_arrays))
    line = _run_in_process(checkout, "tiny_splat1m_train")
    assert line["correct"] is False, line["compared"]
    # The forward pass is untouched: only the gradients' numbers fail.
    failed = {k for k, c in line["compared"].items()
              if (c["value"] > c["limit"]) == (c["fails_if"] == "above")}
    assert failed and all(k.startswith("grad_") for k in failed), line["compared"]


# ------------------------------------------------------- registration cells


def _pose_unchanged(orig):
    def fn(*a, **k):
        res = orig(*a, **k)
        return dataclasses.replace(res, transformation=np.eye(4))
    return fn


def _pose_altered(orig):
    def fn(*a, **k):
        res = orig(*a, **k)
        T = np.array(res.transformation, copy=True)
        T[0, 3] += 0.01
        return dataclasses.replace(res, transformation=T)
    return fn


def _hem_half_left_out(orig):
    def fn(cloud, *a, **k):
        half = cloud.num_points // 2
        cut = dataclasses.replace(cloud, **{f.name: getattr(cloud, f.name)[:half]
                                            for f in dataclasses.fields(cloud)
                                            if torch.is_tensor(getattr(cloud, f.name))})
        return orig(cut, *a, **k)
    return fn


def _points_half_left_out(orig):
    def fn(source, target, *a, **k):
        half = source.num_points // 2
        cut = dataclasses.replace(source, points=source.points[:half],
                                  colors=None if source.colors is None else source.colors[:half])
        return orig(cut, target, *a, **k)
    return fn


REG_FAULTS = [
    ("tiny_reg200k_hem", "state_unchanged", port_ms, "multiscale_mixture_registration",
     _pose_unchanged),
    ("tiny_reg200k_hem", "answer_altered", port_ms, "multiscale_mixture_registration",
     _pose_altered),
    ("tiny_reg200k_hem", "half_left_out", port_hem, "create_mixture", _hem_half_left_out),
    ("tiny_reg200k_voxel", "state_unchanged", port_ms, "multiscale_voxel_registration",
     _pose_unchanged),
    ("tiny_reg200k_voxel", "answer_altered", port_ms, "multiscale_voxel_registration",
     _pose_altered),
    ("tiny_reg200k_voxel", "half_left_out", port_ms, "multiscale_voxel_registration",
     _points_half_left_out),
]


@pytest.mark.parametrize("cell,fault,module,name,wrap", REG_FAULTS,
                         ids=[f"{c}-{f}" for c, f, *_ in REG_FAULTS])
def test_a_broken_registration_is_not_correct(checkout, monkeypatch, cell, fault, module, name,
                                              wrap):
    monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    line = _run_in_process(checkout, cell, seconds=2.0)
    assert line["correct"] is False, line["compared"]


# ------------------------------------------------------------------ controls


def test_the_bf16_transport_control_is_not_correct(checkout):
    rc, line, err = run_cell(checkout, "tiny_splat1m_train", "--control", "bf16_transport")
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["compared"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["splat1m_train", "splat1m_view", "reg200k_hem"])
def test_the_tf32_control_is_not_correct_on_a_card(card, cell):
    from conftest import REPO

    rc, line, err = run_cell(REPO, cell, "--control", "tf32", seconds=3.0, device="cuda")
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["compared"]
