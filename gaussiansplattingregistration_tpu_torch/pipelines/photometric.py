"""Photometric pose registration: optimize SE(3) through the rasterizer.

Torch counterpart of `gaussiansplattingregistration_tpu/pipelines/photometric.py`.
The photometric loss is differentiable end to end: pixel gradients flow
through the tile rasterizer (on "cuda", the composite kernels forward and
backward) into a se(3) twist, and Adam updates the twist.

Pose parametrization: T(xi) = exp(xi) @ T_init with xi in se(3), so every
iterate is exactly rigid. SH rotation is skipped inside the loop (radiance
is nearly pose-invariant over small updates); callers apply the final
transform with full SH rotation via `GaussianCloud.transform`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.ops import math3d, metrics as metrics_ops, se3
from gaussiansplattingregistration_tpu_torch.ops.rasterize import (
    RasterizeConfig,
    rasterize,
    rasterize_arrays,
)
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor, resolve_device


@dataclasses.dataclass
class PhotometricResult:
    transformation: np.ndarray
    loss_history: List[float]
    final_loss: float
    num_steps: int


def _cloud_arrays(cloud: GaussianCloud, dev) -> dict:
    return {
        "means": cloud.xyz.detach().to(dev),
        "cov": cloud.get_covariance().detach().to(dev),
        "opacity": cloud.get_opacity[:, 0].detach().to(dev),
        "features": cloud.get_features.detach().to(dev),
    }


def photometric_pose_opt(
    source: GaussianCloud,
    cameras: Sequence[Camera],
    target_images: Sequence,
    init_transform=None,
    fixed_cloud: Optional[GaussianCloud] = None,
    steps: int = 100,
    learning_rate: float = 5e-3,
    ssim_weight: float = 0.2,
    background=(0.0, 0.0, 0.0),
    config: RasterizeConfig = RasterizeConfig(),
    progress_callback: Optional[Callable[[int, float], None]] = None,
    device=None,
) -> PhotometricResult:
    """Optimize the pose of `source` so its renders match `target_images`,
    on `device` (default `cuda`).

    Loss = (1 - w) * L1 + w * (1 - SSIM) of clip(rgb, 0, 1), averaged over
    cameras; Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root, as torch's). Each step renders every camera forward
    and backward; a camera's graph is freed after its backward.
    """
    dev = resolve_device(device)
    t_init = as_tensor(np.eye(4) if init_transform is None else init_transform, dev)
    bg = as_tensor(background, dev)
    width, height = cameras[0].width, cameras[0].height
    for cam in cameras:
        if (cam.width, cam.height) != (width, height):
            raise ValueError("all cameras must share one resolution for batching")
    views = [(cam.viewmat.to(dev), cam.intrinsics.to(dev), as_tensor(tgt, dev))
             for cam, tgt in zip(cameras, target_images)]

    src = _cloud_arrays(source, dev)
    fixed = None if fixed_cloud is None else _cloud_arrays(fixed_cloud, dev)

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
        rgb, _, _ = rasterize_arrays(means, cov, opacity, features, viewmat, intrinsics,
                                     width, height, source.sh_degree, bg, config, device=dev)
        rgb = torch.clamp(rgb, 0.0, 1.0)
        l1 = torch.mean(torch.abs(rgb - target))
        if ssim_weight > 0:
            return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - metrics_ops.ssim(rgb, target))
        return l1

    xi = torch.zeros(6, dtype=torch.float32, device=dev, requires_grad=True)
    opt = torch.optim.Adam([xi], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    history: List[float] = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = 0.0
        for view in views:
            cam_loss = camera_loss(xi, *view) / len(views)
            cam_loss.backward()
            loss += float(cam_loss.detach())
        opt.step()
        history.append(loss)
        if progress_callback is not None:
            progress_callback(i, loss)

    with torch.no_grad():
        T_final = (se3.se3_exp(xi) @ t_init).cpu().numpy().astype(np.float64)
    return PhotometricResult(
        transformation=T_final,
        loss_history=history,
        final_loss=history[-1] if history else float("nan"),
        num_steps=steps,
    )


def render_targets(
    cloud: GaussianCloud,
    cameras: Sequence[Camera],
    background=(0.0, 0.0, 0.0),
    config: RasterizeConfig = RasterizeConfig(),
    device=None,
) -> List[torch.Tensor]:
    """Render ground-truth target images from a reference cloud (for
    cloud-to-cloud photometric registration and for tests)."""
    out = []
    with torch.no_grad():
        for cam in cameras:
            rgb, _, _ = rasterize(cloud, cam, background=background, config=config,
                                  device=device)
            out.append(torch.clamp(rgb, 0.0, 1.0))
    return out
