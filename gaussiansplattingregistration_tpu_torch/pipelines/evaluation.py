"""Registration evaluation: photometric metrics against ground-truth images.

Torch counterpart of `gaussiansplattingregistration_tpu/pipelines/evaluation.py`
(the reference's `RegistrationEvaluator`): merge the two clouds under the
current transform, render from each camera, compare to
`<images_path>/<img_name>.png`, aggregate MSE/RMSE/SSIM/PSNR (+LPIPS), and
write a JSON log with the reference's `EvaluationObject` schema. Also the
loaders photometric registration shares: a 3DGS `cameras.json` and
ground-truth PNGs, read by the stdlib PNG reader (`utils/png.py`), so no
imaging package is needed. `evaluate_registration_sharded` is the
camera-sharded variant over the ranks of a mesh (`parallel/sharded_eval.py`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.ops import metrics as metrics_ops
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from gaussiansplattingregistration_tpu_torch.utils.device import resolve_device
from gaussiansplattingregistration_tpu_torch.utils.png import read_png


@dataclasses.dataclass
class EvaluationResult:
    """Aggregated metrics + per-camera details + error list."""

    mse: float
    rmse: float
    ssim: float
    psnr: float
    lpips: Optional[float]
    per_camera: List[dict]
    error_list: List[str]
    # which LPIPS weights were live ("torch", "npz:<name>" or "random", the
    # documented random-feature fallback; see ops/lpips.py)
    lpips_weights: Optional[str] = None

    def as_log_dict(self, registration_data: Optional[dict] = None) -> dict:
        """The JSON log (the reference's `EvaluationObject.__dict__`)."""
        return {
            "registration_data": registration_data or {},
            "mse": self.mse,
            "rmse": self.rmse,
            "ssim": self.ssim,
            "psnr": self.psnr,
            "lpips": self.lpips,
            "lpips_weights": self.lpips_weights,
            "error_list": self.error_list,
        }


def load_image(path: str) -> np.ndarray:
    """PNG -> float32 [H, W, 3] in [0, 1]; alpha is dropped and gray
    repeated, as PIL's convert("RGB") does."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    rgb = np.repeat(img[..., :1], 3, axis=2) if img.shape[2] in (1, 2) else img[..., :3]
    return rgb.astype(np.float32) / 255.0


def load_cameras_json(path: str, device=None) -> List[Camera]:
    """Parse a 3DGS-format cameras.json into cameras on `device` (default
    `cuda`)."""
    with open(path) as f:
        entries = json.load(f)
    return [Camera.from_json_entry(e, device=device) for e in entries]


def _ground_truth(camera: Camera, images_path: str, errors: List[str]) -> Optional[np.ndarray]:
    """`camera`'s GT image, or None after noting in `errors` that it is
    missing or that its size differs from the camera's."""
    try:
        gt = load_image(os.path.join(images_path, camera.image_name + ".png"))
    except OSError as e:
        errors.append(str(e))
        return None
    if gt.shape[:2] != (camera.height, camera.width):
        errors.append(
            f"{camera.image_name}: image {gt.shape[:2]} != camera "
            f"({camera.height}, {camera.width})"
        )
        return None
    return gt


def _write_log(result: EvaluationResult, log_path: str,
               registration_data: Optional[dict]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    with open(log_path, "w") as f:
        json.dump(result.as_log_dict(registration_data), f, indent=2)


def evaluate_registration(
    cloud_first: GaussianCloud,
    cloud_second: GaussianCloud,
    transformation,
    cameras: Sequence[Camera],
    images_path: str,
    background=(0.0, 0.0, 0.0),
    log_path: Optional[str] = None,
    registration_data: Optional[dict] = None,
    use_lpips: bool = True,
    config: RasterizeConfig = RasterizeConfig(),
    progress_callback: Optional[Callable[[int], None]] = None,
    device=None,
) -> EvaluationResult:
    """Render the merged cloud from every camera on `device` (default
    `cuda`) and score it against the GT images. A missing image, or one
    whose size differs from its camera's, goes to `error_list`."""
    dev = resolve_device(device)
    merged = cloud_first.merge(cloud_second, transformation)
    lpips_callable = metrics_ops.lpips_fn(dev) if use_lpips else None
    if getattr(lpips_callable, "source", None) == "random":
        print(
            "WARNING: LPIPS is using the untrained random-feature fallback "
            "(no trained AlexNet weights found — set GSR_LPIPS_WEIGHTS or "
            "install the `lpips` package). Values are NOT comparable to "
            "published trained-LPIPS numbers.",
            file=sys.stderr,
        )

    per_camera: List[dict] = []
    errors: List[str] = []
    for i, camera in enumerate(cameras):
        if progress_callback is not None:
            progress_callback(int((i + 1) / len(cameras) * 100))
        gt = _ground_truth(camera, images_path, errors)
        if gt is None:
            continue
        rgb, _, _ = rasterize(merged, camera, background=background, config=config, device=dev)
        m = metrics_ops.all_metrics(torch.clamp(rgb, 0.0, 1.0), torch.as_tensor(gt, device=dev),
                                    lpips_callable)
        m["image"] = camera.image_name
        per_camera.append(m)

    if per_camera:
        agg = {k: float(np.mean([m[k] for m in per_camera]))
               for k in ("mse", "rmse", "ssim", "psnr")}
        lp = (float(np.mean([m["lpips"] for m in per_camera]))
              if lpips_callable is not None else None)
    else:
        agg = {k: float("nan") for k in ("mse", "rmse", "ssim", "psnr")}
        lp = None

    result = EvaluationResult(
        mse=agg["mse"], rmse=agg["rmse"], ssim=agg["ssim"], psnr=agg["psnr"],
        lpips=lp, per_camera=per_camera, error_list=errors,
        lpips_weights=getattr(lpips_callable, "source", None),
    )
    if log_path:
        _write_log(result, log_path, registration_data)
    return result


def evaluate_registration_sharded(
    cloud_first: GaussianCloud,
    cloud_second: GaussianCloud,
    transformation,
    cameras: Sequence[Camera],
    images_path: str,
    background=(0.0, 0.0, 0.0),
    log_path: Optional[str] = None,
    registration_data: Optional[dict] = None,
    config: RasterizeConfig = RasterizeConfig(),
    mesh=None,
    device=None,
) -> EvaluationResult:
    """Camera-sharded (data-parallel) evaluation over the ranks of `mesh`,
    on `device` (default `cuda`); every rank calls it.

    Each rank renders and scores its slice of the camera batch
    (parallel/sharded_eval.py) and the means reduce with one all-reduce.
    Without a mesh, it joins the default group (`distributed.initialize`,
    a world of one without torchrun), splits the cameras over all its
    ranks, and ends the group again if this call made it. Cameras whose GT
    image is missing, or whose size differs from their own or from the
    batch's one resolution, land in `error_list` as in the loop path. LPIPS and the per-camera breakdown are not computed:
    use `evaluate_registration` for those. Only the primary rank writes
    `log_path`."""
    from gaussiansplattingregistration_tpu_torch.parallel import distributed
    from gaussiansplattingregistration_tpu_torch.parallel.sharded_eval import (
        evaluate_images_sharded,
    )

    dev = resolve_device(device)
    made_group = mesh is None and distributed.initialize(device=dev)
    try:
        if mesh is None:
            mesh = distributed.global_mesh(data=distributed.world_size())
        merged = cloud_first.merge(cloud_second, transformation)
        usable: List[Camera] = []
        gts: List[np.ndarray] = []
        errors: List[str] = []
        for camera in cameras:
            gt = _ground_truth(camera, images_path, errors)
            if gt is None:
                continue
            if usable and (camera.width, camera.height) != (usable[0].width, usable[0].height):
                errors.append(
                    f"{camera.image_name}: resolution ({camera.height}, "
                    f"{camera.width}) != batch ({usable[0].height}, {usable[0].width}) — "
                    "sharded evaluation needs one shared resolution"
                )
                continue
            usable.append(camera)
            gts.append(gt)
        if usable:
            agg = evaluate_images_sharded(merged, usable, gts, mesh, background=background,
                                          config=config, device=dev)
        else:
            agg = {k: float("nan") for k in ("mse", "rmse", "ssim", "psnr")}
        primary = distributed.is_primary()
    finally:
        if made_group:
            distributed.shutdown()

    result = EvaluationResult(
        mse=agg["mse"], rmse=agg["rmse"], ssim=agg["ssim"], psnr=agg["psnr"],
        lpips=None, per_camera=[], error_list=errors, lpips_weights=None,
    )
    if log_path and primary:
        _write_log(result, log_path, registration_data)
    return result
