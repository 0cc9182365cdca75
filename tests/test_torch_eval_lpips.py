"""Torch port vs JAX package: LPIPS and the evaluation pipeline.

The random-feature fallback is numpy-seeded in both packages, so its
weights are the same bits and LPIPS agrees within 1e-5 on 64x64 pairs;
weights saved by the JAX package's `save_weights` load in the port and give
the same value. `evaluate_registration` on tests/test_pipelines.py's scene
gives every metric within 1e-4 of JAX's, LPIPS included, and the same
errors for a missing or mis-sized image. GT PNGs are written by the port's
`utils/png.py`.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussiansplattingregistration_tpu.ops import lpips as jlpips
from gaussiansplattingregistration_tpu.ops import metrics as jmetrics
from gaussiansplattingregistration_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gaussiansplattingregistration_tpu.ops.rasterize import rasterize as jrasterize
from gaussiansplattingregistration_tpu.pipelines import evaluation as jeval
from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.ops import lpips, metrics
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig
from gaussiansplattingregistration_tpu_torch.pipelines import evaluation
from gaussiansplattingregistration_tpu_torch.utils.png import write_png
from tests.test_pipelines import make_cams, make_render_scene
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

CFG = RasterizeConfig(max_splats_per_tile=64, tile_chunk=4, backend="torch")
JCFG = JRasterizeConfig(max_splats_per_tile=64, tile_chunk=4)


@pytest.fixture(scope="module")
def params():
    return lpips.default_params("cpu")


def test_random_weights_are_jax_bits(params):
    jp = jlpips._random_params()
    assert params.source == jp.source == "random"
    assert set(params.tensors) == set(jp.tensors)
    for k, v in params.tensors.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp.tensors[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["noise", "perturbed", "identical"])
def test_lpips_matches_jax(rng, params, kind):
    x = rng.uniform(0, 1, size=(64, 64, 3)).astype(np.float32)
    y = {"noise": rng.uniform(0, 1, size=(64, 64, 3)),
         "perturbed": np.clip(x + 0.1 * rng.normal(size=x.shape), 0, 1),
         "identical": x}[kind].astype(np.float32)
    got = float(lpips.lpips(torch.as_tensor(x), torch.as_tensor(y), params))
    want = float(jlpips.lpips(jnp.asarray(x), jnp.asarray(y), jlpips._random_params()))
    assert abs(got - want) <= 1e-5, (got, want)
    if kind == "identical":
        assert got < 1e-6


def test_alexnet_tap_shapes(params):
    taps = lpips._features(torch.zeros((1, 3, 64, 64)), params)
    assert [t.shape[1] for t in taps] == [64, 192, 384, 256, 256]
    assert [t.shape[2] for t in taps] == [15, 7, 3, 3, 3]


def test_weights_saved_by_jax_load_in_port(tmp_path, rng, monkeypatch):
    """The npz layout carries weights across: a JAX-saved file (heads
    changed, so it is not the fallback) gives JAX's value in the port, and
    GSR_LPIPS_WEIGHTS selects it first."""
    jp = jlpips._random_params()
    heads = {f"head{i}": jnp.asarray(rng.uniform(0, 2, size=o).astype(np.float32))
             for i, (o, *_) in enumerate(jlpips._CONVS)}
    jp = jlpips.LPIPSParams(tensors={**jp.tensors, **heads}, source="random")
    path = str(tmp_path / "w.npz")
    jlpips.save_weights(jp, path)
    loaded = lpips.load_weights(path, device="cpu")
    assert loaded.source == "npz:w.npz"
    x, y = (rng.uniform(0, 1, size=(64, 64, 3)).astype(np.float32) for _ in range(2))
    got = float(lpips.lpips(torch.as_tensor(x), torch.as_tensor(y), loaded))
    want = float(jlpips.lpips(jnp.asarray(x), jnp.asarray(y), jlpips.load_weights(path)))
    assert abs(got - want) <= 1e-5, (got, want)
    lpips.save_weights(loaded, str(tmp_path / "again.npz"))
    with np.load(path) as a, np.load(str(tmp_path / "again.npz")) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    monkeypatch.setenv("GSR_LPIPS_WEIGHTS", path)
    lpips._default_host_params.cache_clear()
    try:
        assert lpips.default_params("cpu").source == "npz:w.npz"
    finally:
        lpips._default_host_params.cache_clear()
    bad = dict(np.load(path))
    bad["conv0_w"] = bad["conv0_w"][:, :, :5, :5]
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError, match="conv0_w"):
        lpips.load_weights(str(tmp_path / "bad.npz"), device="cpu")


def test_lpips_fn_in_all_metrics_matches_jax(rng):
    x, y = (rng.uniform(0, 1, size=(48, 48, 3)).astype(np.float32) for _ in range(2))
    fn = metrics.lpips_fn("cpu")
    assert fn.source == "random"
    got = metrics.all_metrics(torch.as_tensor(x), torch.as_tensor(y), fn)
    want = jmetrics.all_metrics(jnp.asarray(x), jnp.asarray(y), jmetrics.lpips_fn())
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k


def _scene(rng, tmp_path, n=60):
    """tests/test_pipelines.py's evaluation scene for both packages, its GT
    PNGs rendered by JAX and written by the port's PNG writer."""
    jcloud = make_render_scene(rng, n=n)
    jcams = make_cams(width=32, height=32)
    merged = jcloud.merge(jcloud)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for cam in jcams:
        rgb, _, _ = jrasterize(merged, cam, config=JCFG)
        write_png(str(img_dir / f"{cam.image_name}.png"),
                  (np.clip(np.asarray(rgb), 0, 1) * 255).astype(np.uint8))
    cloud = GaussianCloud.from_numpy_dict(jcloud.to_numpy_dict(), device="cpu")
    cams = [Camera.create(np.asarray(c.rotation), np.asarray(c.position), float(c.fx),
                          float(c.fy), c.width, c.height, image_name=c.image_name,
                          device="cpu") for c in jcams]
    return jcloud, jcams, cloud, cams, img_dir


@pytest.mark.parametrize("use_lpips", [True, False])
def test_evaluation_matches_jax(rng, tmp_path, use_lpips):
    jcloud, jcams, cloud, cams, img_dir = _scene(rng, tmp_path)
    T = np.eye(4)
    T[:3, 3] = [0.02, 0.0, -0.01]
    log_path = str(tmp_path / "eval.json")
    progress = []
    got = evaluation.evaluate_registration(
        cloud, cloud, T, cams, str(img_dir), log_path=log_path, use_lpips=use_lpips,
        config=CFG, registration_data={"registration_type": "unit-test"},
        progress_callback=progress.append, device="cpu")
    want = jeval.evaluate_registration(jcloud, jcloud, T, jcams, str(img_dir),
                                       use_lpips=use_lpips, config=JCFG)
    assert progress == [33, 66, 100]
    assert not got.error_list and len(got.per_camera) == 3
    for k in ("mse", "rmse", "ssim", "psnr", "lpips"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None) == (k == "lpips" and not use_lpips)
        if a is not None:
            assert abs(a - b) <= 1e-4, (k, a, b)
    for a, b in zip(got.per_camera, want.per_camera):
        assert a["image"] == b["image"] and set(a) == set(b)
    assert got.lpips_weights == want.lpips_weights
    log = json.loads(open(log_path).read())
    assert set(log) == set(want.as_log_dict())
    assert log["registration_data"] == {"registration_type": "unit-test"}
    assert log["psnr"] == got.psnr


def test_evaluation_errors_match_jax(rng, tmp_path):
    """A missing image and one whose size differs from its camera's go to
    error_list, as in JAX; with no usable camera the means are NaN."""
    jcloud, jcams, cloud, cams, img_dir = _scene(rng, tmp_path, n=20)
    (img_dir / "cam1.png").unlink()
    write_png(str(img_dir / "cam2.png"), np.zeros((16, 16, 3), np.uint8))
    got = evaluation.evaluate_registration(cloud, cloud, np.eye(4), cams, str(img_dir),
                                           use_lpips=False, config=CFG, device="cpu")
    want = jeval.evaluate_registration(jcloud, jcloud, np.eye(4), jcams, str(img_dir),
                                       use_lpips=False, config=JCFG)
    assert got.error_list == want.error_list and len(got.error_list) == 2
    assert abs(got.psnr - want.psnr) <= 1e-4
    empty = evaluation.evaluate_registration(cloud, cloud, np.eye(4), cams, str(tmp_path),
                                             use_lpips=False, config=CFG, device="cpu")
    assert len(empty.error_list) == len(cams) and np.isnan(empty.mse) and empty.lpips is None
