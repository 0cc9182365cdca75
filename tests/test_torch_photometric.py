"""Torch port vs JAX package: se(3) maps, image metrics and photometric
pose refinement.

The same seeded numpy inputs go through both packages on the CPU; the port
runs with device="cpu" (the composite kernels' plain twins). Tolerances:
se3 and metrics atol 1e-5 (f32, another order of operations); the first
photometric losses rtol 1e-3 (a rendered, clipped, SSIM-weighted loss
whose gradient carries the rasterizer's 1e-3 tolerance into the pose);
pose recovery as tests/test_pipelines.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussiansplattingregistration_tpu.ops import metrics as jmetrics
from gaussiansplattingregistration_tpu.ops import se3 as jse3
from gaussiansplattingregistration_tpu.pipelines import photometric as jphoto
from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.ops import metrics, se3
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig
from gaussiansplattingregistration_tpu_torch.pipelines import photometric
from tests.test_pipelines import make_cams, make_render_scene
from tests.test_torch_rasterize import jax_config
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")


# ------------------------------------------------------------------ se3

def _twists(rng, kind):
    if kind == "random":
        xi = rng.normal(size=(30, 6))
        xi[:, 3:] *= 0.8
    elif kind == "near_zero":
        xi = rng.normal(size=(30, 6)) * np.logspace(-9, -3, 30)[:, None]
    else:  # near pi, and pi itself
        axis = rng.normal(size=(30, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        theta = np.pi - np.logspace(-6, -3.5, 30)
        theta[0] = np.pi
        xi = np.concatenate([rng.normal(size=(30, 3)), axis * theta[:, None]], axis=1)
    return xi.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "near_zero", "near_pi"])
def test_se3_maps_match_jax(rng, kind):
    xi = _twists(rng, kind)
    pairs = [
        (se3.so3_exp(torch.as_tensor(xi[:, 3:])), jse3.so3_exp(jnp.asarray(xi[:, 3:]))),
        (se3.se3_exp(torch.as_tensor(xi)), jse3.se3_exp(jnp.asarray(xi))),
    ]
    T = np.array(jse3.se3_exp(jnp.asarray(xi)))
    pairs += [
        (se3.so3_log(torch.as_tensor(T[:, :3, :3])), jse3.so3_log(jnp.asarray(T[:, :3, :3]))),
        (se3.se3_log(torch.as_tensor(T)), jse3.se3_log(jnp.asarray(T))),
        (se3.se3_inverse(torch.as_tensor(T)), jse3.se3_inverse(jnp.asarray(T))),
    ]
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    pairs.append((se3.apply_se3(torch.as_tensor(T[0]), torch.as_tensor(pts)),
                  jse3.apply_se3(jnp.asarray(T[0]), jnp.asarray(pts))))
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=str(i))


def test_se3_exp_gradient_at_zero_matches_jax(rng):
    """The Taylor guards set the derivative at xi = 0, which every
    photometric step starts from."""
    pts = rng.normal(size=(8, 3)).astype(np.float32)
    w = rng.normal(size=(8, 3)).astype(np.float32)

    def jloss(xi):
        return jnp.sum(jse3.apply_se3(jse3.se3_exp(xi), jnp.asarray(pts)) * w)

    want = np.asarray(jax.grad(jloss)(jnp.zeros(6)))
    xi = torch.zeros(6, requires_grad=True)
    loss = torch.sum(se3.apply_se3(se3.se3_exp(xi), torch.as_tensor(pts)) * torch.as_tensor(w))
    (got,) = torch.autograd.grad(loss, xi)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# -------------------------------------------------------------- metrics

@pytest.mark.parametrize("shape", [(32, 24, 3), (3, 20, 20), (17, 9, 1)])
def test_metrics_match_jax(rng, shape):
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    ta, tb, ja, jb = torch.as_tensor(a), torch.as_tensor(b), jnp.asarray(a), jnp.asarray(b)
    for name in ("mse", "rmse", "psnr", "ssim"):
        got = float(getattr(metrics, name)(ta, tb))
        want = float(getattr(jmetrics, name)(ja, jb))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(metrics.ssim(ta, tb, size_average=False).numpy(),
                               np.asarray(jmetrics.ssim(ja, jb, size_average=False)), atol=1e-5)
    got, want = metrics.all_metrics(ta, tb), jmetrics.all_metrics(ja, jb)
    assert set(got) == set(want) == {"mse", "rmse", "ssim", "psnr"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert metrics.all_metrics(ta, tb, lambda x, y: 0.25)["lpips"] == 0.25


def test_ssim_gradient_matches_jax(rng):
    a = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    b = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jmetrics.ssim(x, jnp.asarray(b)))(jnp.asarray(a)))
    x = torch.tensor(a, requires_grad=True)
    (got,) = torch.autograd.grad(metrics.ssim(x, torch.as_tensor(b)), x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()))


# ------------------------------------------------------------ photometric

def port_scene(jcloud, jcams):
    cloud = GaussianCloud.from_numpy_dict(jcloud.to_numpy_dict(), device="cpu")
    cams = [Camera.from_numpy(np.asarray(c.rotation), np.asarray(c.position), float(c.fx),
                              float(c.fy), c.width, c.height, device="cpu") for c in jcams]
    return cloud, cams


def moved_scene(rng):
    """A scene, its targets, and the cloud moved off its pose by T_gt^-1."""
    jcloud = make_render_scene(rng)
    jcams = make_cams()
    xi = np.array([0.03, -0.02, 0.02, 0.03, -0.02, 0.03], np.float32)
    T_gt = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    return jcloud, jcams, T_gt, jcloud.transform(jnp.asarray(np.linalg.inv(T_gt), jnp.float32))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_photometric_first_losses_match_jax(rng, backend):
    jcloud, jcams, _, jmoved = moved_scene(rng)
    cfg = RasterizeConfig(max_splats_per_tile=64, tile_chunk=4, backend=backend)
    targets = [np.asarray(t) for t in jphoto.render_targets(jcloud, jcams, config=jax_config(cfg))]
    want = jphoto.photometric_pose_opt(jmoved, jcams, targets, steps=3, learning_rate=8e-3,
                                       config=jax_config(cfg))
    moved, cams = port_scene(jmoved, jcams)
    got = photometric.photometric_pose_opt(moved, cams, targets, steps=3, learning_rate=8e-3,
                                           config=cfg, device="cpu")
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-3)
    assert got.num_steps == 3 and got.final_loss == got.loss_history[-1]
    np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-4)


def test_photometric_pose_opt_recovers_small_offset(rng):
    """tests/test_pipelines.py's case, on the port's main path ("cuda",
    here the kernels' twins): 3 cameras at 48x48, 60 steps."""
    jcloud, jcams, T_gt, jmoved = moved_scene(rng)
    cloud, cams = port_scene(jcloud, jcams)
    moved, _ = port_scene(jmoved, jcams)
    cfg = RasterizeConfig(max_splats_per_tile=64, tile_chunk=4)
    targets = photometric.render_targets(cloud, cams, config=cfg, device="cpu")
    assert all(t.shape == (48, 48, 3) and float(t.max()) <= 1.0 for t in targets)
    result = photometric.photometric_pose_opt(moved, cams, targets, steps=60,
                                              learning_rate=8e-3, ssim_weight=0.0,
                                              config=cfg, device="cpu")
    err = float(torch.linalg.norm(se3.se3_log(
        torch.as_tensor(result.transformation @ np.linalg.inv(T_gt), dtype=torch.float32))))
    assert err < 0.01, (err, result.final_loss)
    assert result.loss_history[-1] < result.loss_history[0] * 0.2


def test_photometric_raises_without_cuda_unless_cpu(rng, monkeypatch):
    jcloud = make_render_scene(rng, n=8)
    cloud, cams = port_scene(jcloud, make_cams(width=16, height=16))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        photometric.photometric_pose_opt(cloud, cams, [np.zeros((16, 16, 3))] * 3, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        photometric.render_targets(cloud, cams)
    assert photometric.photometric_pose_opt(cloud, cams, [np.zeros((16, 16, 3))] * 3, steps=1,
                                            device="cpu").num_steps == 1
