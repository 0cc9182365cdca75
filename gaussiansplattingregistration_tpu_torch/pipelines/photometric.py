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
from gaussiansplattingregistration_tpu_torch.utils import profiling
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


class PhotometricRefiner:
    """Photometric pose refinement one Adam step at a time: the prepared
    views, the twist `xi` and Adam's state. `photometric_pose_opt` is the
    loop over `step()`; a benchmark, a viewer or a progress bar drives the
    same step.

    Loss = (1 - w) * L1 + w * (1 - SSIM) of clip(rgb, 0, 1), averaged over
    cameras; Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root, as torch's). Each step renders every camera forward
    and backward, the pose and the merge recomputed per camera; a camera's
    graph is freed after its backward. That backward runs in two phases,
    the loss's VJP to the rendered image, then the image's to `xi` (the
    values of one `backward()`), so that each phase has its span.

    Spans (`utils/profiling.py`) of a step: `photometric.step`, per camera
    `photometric.pose`, `photometric.merge`, `photometric.loss`,
    `photometric.loss_vjp` and `photometric.render_vjp`, then
    `photometric.adam`. Counters, added once a step: `photometric.views`,
    `photometric.pixels` (W·H·views) and `photometric.splats` (the merged
    splats of a view).
    """

    def __init__(
        self,
        source: GaussianCloud,
        cameras: Sequence[Camera],
        target_images: Sequence,
        init_transform=None,
        fixed_cloud: Optional[GaussianCloud] = None,
        learning_rate: float = 5e-3,
        ssim_weight: float = 0.2,
        background=(0.0, 0.0, 0.0),
        config: RasterizeConfig = RasterizeConfig(),
        device=None,
    ):
        dev = self.device = resolve_device(device)
        self.background = as_tensor(background, dev)
        self.width, self.height = cameras[0].width, cameras[0].height
        for cam in cameras:
            if (cam.width, cam.height) != (self.width, self.height):
                raise ValueError("all cameras must share one resolution for batching")
        self.views = [(cam.viewmat.to(dev), cam.intrinsics.to(dev), as_tensor(tgt, dev))
                      for cam, tgt in zip(cameras, target_images)]
        self.fixed = None if fixed_cloud is None else _cloud_arrays(fixed_cloud, dev)
        self.learning_rate, self.ssim_weight, self.config = learning_rate, ssim_weight, config
        self.last_renders: List[torch.Tensor] = []
        self.last_losses: List[float] = []
        self.restart(source, init_transform)

    def restart(self, source: Optional[GaussianCloud] = None, init_transform=None) -> None:
        """A new job from `init_transform` (None = identity): `xi` = 0 and
        fresh Adam state, and `source` in place of the current one where it
        is given."""
        dev = self.device
        if source is not None:
            self.sh_degree = source.sh_degree
            self.src = _cloud_arrays(source, dev)
        self.t_init = as_tensor(np.eye(4) if init_transform is None else init_transform, dev)
        self.xi = torch.zeros(6, dtype=torch.float32, device=dev, requires_grad=True)
        self.opt = torch.optim.Adam([self.xi], lr=self.learning_rate, betas=(0.9, 0.999),
                                    eps=1e-8)

    def _render(self, viewmat, intrinsics) -> torch.Tensor:
        """The source at exp(xi) @ T_init merged with the fixed cloud, from
        one camera: rgb [H, W, 3] before the clip."""
        src, fixed = self.src, self.fixed
        with profiling.span("photometric.pose"):
            T = se3.se3_exp(self.xi) @ self.t_init
            R = T[:3, :3]
            means = src["means"] @ R.T + T[:3, 3]
            cov = math3d.transform_covariance(src["cov"], R)
        opacity, features = src["opacity"], src["features"]
        if fixed is not None:
            with profiling.span("photometric.merge"):
                means = torch.cat([means, fixed["means"]])
                cov = torch.cat([cov, fixed["cov"]])
                opacity = torch.cat([opacity, fixed["opacity"]])
                features = torch.cat([features, fixed["features"]])
        rgb, _, _ = rasterize_arrays(means, cov, opacity, features, viewmat, intrinsics,
                                     self.width, self.height, self.sh_degree, self.background,
                                     self.config, device=self.device)
        return rgb

    def _camera_loss(self, rgb: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """One camera's share of the step's loss."""
        with profiling.span("photometric.loss"):
            rgb = torch.clamp(rgb, 0.0, 1.0)
            l1 = torch.mean(torch.abs(rgb - target))
            w = self.ssim_weight
            if w > 0:
                loss = (1.0 - w) * l1 + w * (1.0 - metrics_ops.ssim(rgb, target))
            else:
                loss = l1
            return loss / len(self.views)

    def step(self, keep_renders: bool = False) -> float:
        """One Adam step over every camera; returns the step's loss, the sum
        of the cameras' shares, each read to the host and kept in
        `last_losses`. With `keep_renders`, `last_renders` holds each
        camera's clipped render of the step."""
        n_splats = self.src["means"].shape[0]
        if self.fixed is not None:
            n_splats += self.fixed["means"].shape[0]
        renders, losses = [], []
        with profiling.span("photometric.step"):
            profiling.count("photometric.views", len(self.views))
            profiling.count("photometric.pixels", self.width * self.height * len(self.views))
            profiling.count("photometric.splats", n_splats)
            self.opt.zero_grad(set_to_none=True)
            loss = 0.0
            for viewmat, intrinsics, target in self.views:
                rgb = self._render(viewmat, intrinsics)
                cam_loss = self._camera_loss(rgb, target)
                with profiling.span("photometric.loss_vjp"):
                    (d_rgb,) = torch.autograd.grad(cam_loss, rgb)
                with profiling.span("photometric.render_vjp"):
                    rgb.backward(d_rgb)
                losses.append(float(cam_loss.detach()))
                loss += losses[-1]
                if keep_renders:
                    renders.append(torch.clamp(rgb.detach(), 0.0, 1.0))
            with profiling.span("photometric.adam"):
                self.opt.step()
        self.last_losses = losses
        if keep_renders:
            self.last_renders = renders
        return loss

    @property
    def transformation(self) -> np.ndarray:
        """The current pose exp(xi) @ T_init, float64 [4, 4]."""
        with torch.no_grad():
            return (se3.se3_exp(self.xi) @ self.t_init).cpu().numpy().astype(np.float64)


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
    on `device` (default `cuda`): `steps` steps of a `PhotometricRefiner`,
    whose docstring gives the loss and the optimizer."""
    refiner = PhotometricRefiner(source, cameras, target_images, init_transform, fixed_cloud,
                                 learning_rate, ssim_weight, background, config, device)
    history: List[float] = []
    for i in range(steps):
        loss = refiner.step()
        history.append(loss)
        if progress_callback is not None:
            progress_callback(i, loss)
    return PhotometricResult(
        transformation=refiner.transformation,
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
