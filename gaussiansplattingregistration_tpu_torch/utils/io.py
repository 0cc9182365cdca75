"""File loading/saving: Gaussian PLYs, and type-sniffing PLY loads.

Torch counterpart of `gaussiansplattingregistration_tpu/utils/io.py`:
parsing stays host-side numpy, arrays go to the device once.
"""

from __future__ import annotations

import os

import torch

from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.utils import ply as ply_io
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor, resolve_device


def load_gaussian_cloud(path: str, device=None) -> GaussianCloud:
    """Load a 3DGS Gaussian PLY onto `device` (default `cuda`)."""
    data = ply_io.read_ply(path)
    if ply_io.check_point_cloud_type(data) is not ply_io.PointCloudType.GAUSSIAN:
        raise ValueError(f"{path} is not a Gaussian splat PLY")
    arrays = ply_io.gaussian_arrays_from_ply(data)
    sh_degree = arrays.pop("sh_degree")
    return GaussianCloud.create(sh_degree=sh_degree, device=device, **arrays)


def save_gaussian_cloud(cloud: GaussianCloud, path: str) -> None:
    """Save in the 3DGS PLY layout."""
    d = cloud.to_numpy_dict()
    cols = ply_io.gaussian_arrays_to_ply_columns(
        d["xyz"], d["features_dc"], d["features_rest"],
        d["opacity"], d["scaling"], d["rotation"],
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ply_io.write_ply(path, cols)


def _point_cloud(xyz, rgb, normals, device) -> PointCloud:
    dev = resolve_device(device)
    return PointCloud(points=as_tensor(xyz, dev), colors=as_tensor(rgb, dev),
                      normals=None if normals is None else as_tensor(normals, dev))


def load_point_cloud_any(path: str, device=None):
    """Type-sniffing loader: a GaussianCloud or a PointCloud."""
    data = ply_io.read_ply(path)
    kind = ply_io.check_point_cloud_type(data)
    if kind is ply_io.PointCloudType.GAUSSIAN:
        arrays = ply_io.gaussian_arrays_from_ply(data)
        sh_degree = arrays.pop("sh_degree")
        return GaussianCloud.create(sh_degree=sh_degree, device=device, **arrays)
    if kind is ply_io.PointCloudType.SPARSE:
        return _point_cloud(*ply_io.sparse_arrays_from_ply(data), device)
    raise ValueError(f"unrecognized point cloud type in {path}")


def gaussian_to_point_cloud(
    cloud: GaussianCloud, estimate_missing_normals: bool = False
) -> PointCloud:
    """GaussianCloud -> registration PointCloud: positions, sh2rgb colors
    clipped to [0,1], packed covariances attached."""
    if estimate_missing_normals:
        raise NotImplementedError(
            "normal estimation waits for the port of ops/normals.py "
            "(ROADMAP.md, Queue 1, slice 3: neighbor search and point-cloud prep)"
        )
    return PointCloud(
        points=cloud.xyz,
        colors=torch.clamp(cloud.get_rgb, 0.0, 1.0),
        covariances=cloud.get_covariance(),
    )
