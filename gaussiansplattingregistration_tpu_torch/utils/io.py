"""File loading/saving: Gaussian PLYs, sparse PLYs, type-sniffing loads.

Torch counterpart of `gaussiansplattingregistration_tpu/utils/io.py`:
parsing stays host-side numpy, arrays go to the device once.
"""

from __future__ import annotations

import os

import numpy as np
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


def load_sparse_cloud(path: str, device=None) -> PointCloud:
    """Load a sparse/SfM PLY with RGB colors onto `device` (default `cuda`)."""
    data = ply_io.read_ply(path)
    if ply_io.check_point_cloud_type(data) is not ply_io.PointCloudType.SPARSE:
        raise ValueError(f"{path} is not a sparse (SfM) PLY")
    return _point_cloud(*ply_io.sparse_arrays_from_ply(data), device)


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
    clipped to [0,1], packed covariances attached; with
    `estimate_missing_normals`, normals from `ops.normals`."""
    pc = PointCloud(
        points=cloud.xyz,
        colors=torch.clamp(cloud.get_rgb, 0.0, 1.0),
        covariances=cloud.get_covariance(),
    )
    if estimate_missing_normals:
        from gaussiansplattingregistration_tpu_torch.ops import normals as normals_ops

        pc = normals_ops.with_estimated_normals(pc)
    return pc


def save_point_cloud(pc: PointCloud, path: str) -> None:
    """Save a sparse point cloud as PLY (colors in 0-255 uchar)."""
    host = lambda a: a.detach().cpu().numpy().astype(np.float32)  # noqa: E731
    points = host(pc.points)
    cols = {"x": points[:, 0], "y": points[:, 1], "z": points[:, 2]}
    if pc.normals is not None:
        normals = host(pc.normals)
        for i, name in enumerate(("nx", "ny", "nz")):
            cols[name] = normals[:, i]
    colors = np.zeros((pc.num_points, 3), np.float32) if pc.colors is None else host(pc.colors)
    rgb255 = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    for i, name in enumerate(("red", "green", "blue")):
        cols[name] = rgb255[:, i]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ply_io.write_ply(path, cols)
