"""The port's photometric step (`PhotometricRefiner.step`) against the
benchmark's plain reference (`splatbench/reference/photometric.py`) on the
CPU, on seeded pairs of 1,500-splat room captures seen by 3 cameras at
61x45 (partial tiles), with and without the fixed capture, SSIM weight 0.2
and 0; `photometric_pose_opt` as the loop over `step()`, bit for bit; and
the step's two-phase backward against one `backward()`.

Tolerances: both sides are float32 with the same formulas, summed in other
orders (the port's kernel twins composite a tile in 128-entry chunks, the
reference in one cumsum; SSIM's blur and the L1 mean reduce alike), so the
renders differ by a few float32 ulps of [0, 1] (1e-5 leaves 20x room over
the 4.2e-7 seen), a view's loss by a few ulps of its sum (2e-5 relative,
over the 4.3e-6 seen), and a view's gradient of `xi`, a sum over every
pixel and splat, by 1e-4 of its norm (over the 7.2e-7 seen; seeds 11, 23
and 31, every case). After 3 Adam steps the poses agree to 1e-5: each step
moves `xi` by about the learning rate times the sign of the bias-corrected
moment ratio, which the gradients' gaps barely move.
"""

import math

import numpy as np
import pytest
import torch

from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.ops import math3d, metrics as metrics_ops, se3
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig, rasterize_arrays
from gaussiansplattingregistration_tpu_torch.pipelines import photometric
from splatbench import scenes
from splatbench.drivers import photometric as drv
from splatbench.reference import photometric as ref
from splatbench.reference import raster as ref_raster
from port_scenes import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

W, H, DEG, N, LR = 61, 45, 3, 1500, 5e-3
ROOM = {"draw": "room", "sh_degree": DEG, "room": [4.0, 3.0, 2.5],
        "boxes": [[0.8, 0.5, -0.85, 1.2, 0.8, 0.8], [-1.7, 0.9, -0.35, 0.5, 1.0, 1.8],
                  [-0.5, -1.1, -0.95, 1.8, 0.7, 0.6], [1.5, -1.1, -0.75, 0.8, 0.6, 1.0],
                  [0.7, 0.4, -0.3, 0.3, 0.3, 0.3], [0.2, 1.2, 0.0, 0.3, 0.3, 2.5]],
        "tangent_scale": [0.08, 0.16], "normal_scale": [0.008, 0.016], "normal_jitter": 0.002,
        "dc_std": 0.5, "rest_std": 0.1, "opacity_logit_std": 1.0}
CAMERAS = {"width": W, "height": H, "fov_deg": 67.6, "distance": 1.2, "height_z": 0.0,
           "yaws_deg": [0, 120, 240]}
RASTER = {"tile_size": 16, "max_tiles_per_splat": 16, "max_splats_per_tile": 1024,
          "tile_chunk": 32, "radius_clip": 3.0, "near": 0.2, "eps2d": 0.3,
          "alpha_clip": 1.0 / 255.0, "alpha_max": 0.999, "transmittance_min": 1e-4}
CONFIG = RasterizeConfig(**RASTER)
CASES = [(True, 0.2), (True, 0.0), (False, 0.2), (False, 0.0)]
IDS = ["pair-ssim", "pair-l1", "alone-ssim", "alone-l1"]


def pair(seed: int, with_fixed: bool):
    """(refiner on the moved capture, reference inputs): two room captures
    drawn from `seed` and `seed + 1`, the second moved by 0.02 and 1
    degree, the targets rendered by the port at the truth."""
    fixed_raw = scenes.reg_scene(ROOM, N, seed, "cpu")
    moving_raw = scenes.reg_scene(ROOM, N, seed + 1, "cpu")
    motion = scenes.rigid_motions(seed, 1, 0.02, 1.0)[0]
    views = drv.look_at_views(CAMERAS, "cpu")
    cams = drv.port_cameras(views, W, H)
    fixed_cloud = drv.cloud(fixed_raw, DEG, "cpu") if with_fixed else None
    truth = drv.cloud(moving_raw, DEG, "cpu")
    scene = truth.merge(fixed_cloud) if with_fixed else truth
    targets = photometric.render_targets(scene, cams, config=CONFIG, device="cpu")
    moved = drv.moved(moving_raw, motion)
    inputs = {"views": views, "targets": targets, "moving": drv.arrays(moved),
              "fixed": drv.arrays(fixed_raw) if with_fixed else None}
    return drv.cloud(moved, DEG, "cpu"), cams, targets, fixed_cloud, inputs


def refiner_of(seed, with_fixed, ssim_weight):
    source, cams, targets, fixed_cloud, inputs = pair(seed, with_fixed)
    r = photometric.PhotometricRefiner(source, cams, targets, fixed_cloud=fixed_cloud,
                                       learning_rate=LR, ssim_weight=ssim_weight,
                                       config=CONFIG, device="cpu")
    return r, inputs


def port_step(r):
    """One `step()` with each view's gradient of `xi` caught by a hook."""
    grads = []
    hook = r.xi.register_hook(lambda g: grads.append(g.detach().clone()))
    xi = r.xi.detach().clone()
    try:
        loss = r.step(keep_renders=True)
    finally:
        hook.remove()
    return xi, grads, loss


def reference_view(xi, inputs, v, ssim_weight):
    p = ref_raster.RasterParams.from_config(RASTER)
    return ref.view_step(xi, torch.eye(4), inputs["moving"], inputs["fixed"], inputs["views"][v],
                         inputs["targets"][v], W, H, DEG, p, ssim_weight, len(inputs["views"]))


@pytest.mark.parametrize("with_fixed,ssim_weight", CASES, ids=IDS)
def test_a_step_matches_the_reference_at_every_view(with_fixed, ssim_weight):
    r, inputs = refiner_of(11, with_fixed, ssim_weight)
    xi, grads, loss = port_step(r)
    assert len(grads) == len(inputs["views"]) == 3
    assert loss == pytest.approx(sum(r.last_losses), rel=1e-12)
    for v in range(3):
        want = reference_view(xi, inputs, v, ssim_weight)
        assert float((r.last_renders[v] - want["rgb"]).abs().max()) < 1e-5, v
        assert r.last_losses[v] == pytest.approx(float(want["loss"]), rel=2e-5), v
        for part in (slice(0, 3), slice(3, 6)):        # translation, rotation
            gap = torch.linalg.vector_norm(grads[v][part] - want["grad"][part])
            assert float(gap) <= 1e-4 * float(torch.linalg.vector_norm(want["grad"][part])), v


@pytest.mark.parametrize("with_fixed,ssim_weight", CASES, ids=IDS)
def test_the_pose_after_three_steps_matches_the_reference_adam(with_fixed, ssim_weight):
    r, inputs = refiner_of(23, with_fixed, ssim_weight)
    xi = torch.zeros(6)
    m, v2 = torch.zeros(6), torch.zeros(6)
    for t in range(1, 4):
        r.step()
        g = sum(reference_view(xi, inputs, v, ssim_weight)["grad"] for v in range(3))
        xi, m, v2 = ref.adam_step(xi, g, m, v2, t, LR)
    want = (ref.se3_exp(xi)).double().numpy()
    np.testing.assert_allclose(r.transformation, want, atol=1e-5)
    assert float(torch.linalg.vector_norm(xi)) > 2 * LR       # the steps moved the pose


def direct_loop(source, cams, targets, fixed_cloud, steps, ssim_weight):
    """The loop `photometric_pose_opt` ran before it was split into
    `PhotometricRefiner.step()`, written out."""
    src = photometric._cloud_arrays(source, torch.device("cpu"))
    fixed = None if fixed_cloud is None else photometric._cloud_arrays(fixed_cloud, "cpu")
    views = [(c.viewmat, c.intrinsics, t) for c, t in zip(cams, targets)]
    t_init = torch.eye(4)

    def camera_loss(xi, viewmat, intrinsics, target):
        T = se3.se3_exp(xi) @ t_init
        R = T[:3, :3]
        means = src["means"] @ R.T + T[:3, 3]
        cov = math3d.transform_covariance(src["cov"], R)
        opacity, features = src["opacity"], src["features"]
        if fixed is not None:
            means = torch.cat([means, fixed["means"]])
            cov = torch.cat([cov, fixed["cov"]])
            opacity = torch.cat([opacity, fixed["opacity"]])
            features = torch.cat([features, fixed["features"]])
        rgb, _, _ = rasterize_arrays(means, cov, opacity, features, viewmat, intrinsics, W, H,
                                     DEG, torch.zeros(3), CONFIG, device="cpu")
        rgb = torch.clamp(rgb, 0.0, 1.0)
        l1 = torch.mean(torch.abs(rgb - target))
        if ssim_weight > 0:
            return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - metrics_ops.ssim(rgb, target))
        return l1

    xi = torch.zeros(6, dtype=torch.float32, requires_grad=True)
    opt = torch.optim.Adam([xi], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    history = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = 0.0
        for view in views:
            cam_loss = camera_loss(xi, *view) / len(views)
            cam_loss.backward()
            loss += float(cam_loss.detach())
        opt.step()
        history.append(loss)
    with torch.no_grad():
        return history, (se3.se3_exp(xi) @ t_init).numpy().astype(np.float64)


@pytest.mark.parametrize("with_fixed,ssim_weight", CASES, ids=IDS)
def test_photometric_pose_opt_is_bit_equal_to_the_direct_loop(with_fixed, ssim_weight):
    source, cams, targets, fixed_cloud, _ = pair(5, with_fixed)
    seen = []
    got = photometric.photometric_pose_opt(source, cams, targets, fixed_cloud=fixed_cloud,
                                           steps=4, learning_rate=LR, ssim_weight=ssim_weight,
                                           config=CONFIG, device="cpu",
                                           progress_callback=lambda i, l: seen.append((i, l)))
    history, pose = direct_loop(source, cams, targets, fixed_cloud, 4, ssim_weight)
    assert got.loss_history == history
    assert seen == list(enumerate(history)) and got.final_loss == history[-1]
    assert np.array_equal(got.transformation, pose)


@pytest.mark.parametrize("with_fixed,ssim_weight", CASES, ids=IDS)
def test_the_two_phase_backward_equals_one_backward(with_fixed, ssim_weight):
    r, inputs = refiner_of(31, with_fixed, ssim_weight)
    _, two_phase, _ = port_step(r)
    r.restart()
    for v, (vm, intr, target) in enumerate(r.views):
        r.xi.grad = None
        r._camera_loss(r._render(vm, intr), target).backward()
        assert torch.equal(r.xi.grad, two_phase[v]), v


def test_restart_starts_a_new_job_from_zero():
    r, _ = refiner_of(7, True, 0.2)
    first = [r.step() for _ in range(2)]
    r.restart()
    assert float(r.xi.detach().abs().max()) == 0.0 and not r.opt.state
    again = [r.step() for _ in range(2)]
    assert again == first
    assert math.isfinite(first[-1]) and np.allclose(r.transformation[3], [0, 0, 0, 1])


def test_the_driver_cameras_look_at_the_centre():
    views = drv.look_at_views(CAMERAS, "cpu")
    drv.check_cameras(ROOM, views)
    for (vm, intr), yaw in zip(views, CAMERAS["yaws_deg"]):
        centre = -(vm[:3, :3].T @ vm[:3, 3])
        assert float(torch.linalg.vector_norm(centre)) == pytest.approx(1.2, rel=1e-6)
        assert math.degrees(math.atan2(float(centre[1]), float(centre[0]))) % 360 == \
            pytest.approx(yaw, abs=1e-4)
        origin = vm[:3, :3] @ torch.zeros(3) + vm[:3, 3]              # in the camera frame
        assert float(origin[2]) == pytest.approx(1.2, rel=1e-6)      # straight ahead
        assert float(origin[:2].abs().max()) < 1e-6
        assert torch.allclose(Camera(rotation=vm[:3, :3].T, position=vm[:3, 3],
                                     fx=intr[0, 0], fy=intr[1, 1], width=W,
                                     height=H).viewmat, vm)
    with pytest.raises(ValueError, match="inside the box"):
        drv.check_cameras({**ROOM, "boxes": [[1.2, 0.0, 0.0, 0.2, 0.2, 0.2]]}, views)
