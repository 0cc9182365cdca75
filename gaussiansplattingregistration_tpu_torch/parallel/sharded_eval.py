"""Camera-sharded (data-parallel) photometric evaluation. Counterpart of
`gaussiansplattingregistration_tpu/parallel/sharded_eval.py`.

Each rank renders its slice of the camera batch and scores it (MSE and
SSIM per camera, RMSE and PSNR per image); the sums reduce with one
all-reduce over the mesh's `data` axis.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models.camera import Camera
from gaussiansplattingregistration_tpu_torch.ops import metrics as metrics_ops
from gaussiansplattingregistration_tpu_torch.ops.rasterize import RasterizeConfig, rasterize_arrays
from gaussiansplattingregistration_tpu_torch.parallel import collectives
from gaussiansplattingregistration_tpu_torch.parallel.mesh import axis_size
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor, resolve_device


def evaluate_images_sharded(
    cloud,
    cameras: Sequence[Camera],
    gt_images: Sequence[np.ndarray],
    mesh,
    background=(0.0, 0.0, 0.0),
    config: RasterizeConfig = RasterizeConfig(),
    device=None,
) -> dict:
    """Render and score a camera batch, sharded over the mesh's `data` axis,
    on `device` (default `cuda`); every rank holds the whole cloud.

    All cameras must share one resolution. Returns the mean metrics (mse,
    rmse, psnr, ssim) on every rank. The camera count is padded to a
    multiple of the data-axis size; a padded slot is skipped and counts in
    no mean (the JAX package renders it and masks it out)."""
    dev = resolve_device(device)
    n_data, my = axis_size(mesh, "data"), mesh.get_local_rank("data")
    width, height = cameras[0].width, cameras[0].height
    n = len(cameras)
    per_rank = -(-n // n_data)
    bg = as_tensor(background, dev)
    splats = (cloud.xyz.to(dev), cloud.get_covariance().to(dev),
              cloud.get_opacity[:, 0].to(dev), cloud.get_features.to(dev))

    # count, then the sums of mse, rmse, psnr and ssim over this rank's slice
    sums = torch.zeros(5, dtype=torch.float64, device=dev)
    with torch.no_grad():
        for i in range(my * per_rank, min((my + 1) * per_rank, n)):
            cam = cameras[i]
            rgb, _, _ = rasterize_arrays(*splats, cam.viewmat.to(dev), cam.intrinsics.to(dev),
                                         width, height, cloud.sh_degree, bg, config, device=dev)
            rgb = torch.clamp(rgb, 0.0, 1.0)
            tgt = as_tensor(gt_images[i], dev)
            m = metrics_ops.mse(rgb, tgt)
            # PSNR and RMSE per image, then averaged (the reference
            # accumulates per-image metrics), not derived from the mean MSE.
            rmse = torch.sqrt(m)
            psnr = -20.0 * torch.log10(torch.clamp_min(rmse, 1e-9))
            sums += torch.stack([torch.ones_like(m), m, rmse, psnr,
                                 metrics_ops.ssim(rgb, tgt)]).to(torch.float64)
    sums = collectives.all_reduce(sums, "sum", mesh.get_group("data")).cpu()
    count = float(sums[0])
    return {k: float(sums[i + 1]) / count for i, k in enumerate(("mse", "rmse", "psnr", "ssim"))}
