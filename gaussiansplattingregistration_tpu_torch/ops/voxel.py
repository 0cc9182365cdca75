"""Voxel-grid downsampling: points averaged per occupied voxel.

Torch counterpart of `gaussiansplattingregistration_tpu/ops/voxel.py`
(Open3D's `voxel_down_sample` semantics). Voxels come out in lexicographic
(ix, iy, iz) order, as the JAX function's three-key sort gives them: here
one int64 key packed ix-major and one stable sort. Segment means are
`index_add_` sums over counts. The JAX function's padded, static-shaped
form exists for its compiler; eager torch needs only the compacted cloud.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud


def voxel_downsample(
    pc: PointCloud, voxel_size: float, max_voxels: Optional[int] = None
) -> PointCloud:
    """A compacted PointCloud with one point per occupied voxel (the mean of
    its points; colors and normals averaged too, normals renormalized). With
    `max_voxels`, only the first `max_voxels` voxels in key order are kept,
    as the JAX function's static budget keeps them."""
    points = pc.points
    origin = torch.min(points, dim=0).values
    ijk = torch.floor((points - origin) / voxel_size).to(torch.int64)
    dims = ijk.max(dim=0).values + 1
    key = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    sorted_key, order = torch.sort(key, stable=True)
    _, counts = torch.unique_consecutive(sorted_key, return_counts=True)
    n_vox = counts.shape[0] if max_voxels is None else min(counts.shape[0], int(max_voxels))
    seg = torch.repeat_interleave(torch.arange(counts.shape[0], device=points.device), counts)
    denom = torch.clamp_min(counts[:n_vox].to(points.dtype), 1.0)[:, None]
    keep = seg < n_vox

    def seg_mean(x):
        if x is None:
            return None
        s = torch.zeros((n_vox, x.shape[1]), dtype=x.dtype, device=x.device)
        s.index_add_(0, seg[keep], x[order][keep])
        return s / denom

    out = PointCloud(points=seg_mean(points), colors=seg_mean(pc.colors),
                     normals=seg_mean(pc.normals))
    if out.normals is not None:
        norm = torch.linalg.norm(out.normals, dim=-1, keepdim=True)
        out = dataclasses.replace(out, normals=out.normals / torch.clamp_min(norm, 1e-12))
    return out
