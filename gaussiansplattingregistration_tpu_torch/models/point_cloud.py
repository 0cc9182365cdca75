"""PointCloud: plain point cloud (the Open3D-point-cloud analogue).

Torch counterpart of `gaussiansplattingregistration_tpu/models/point_cloud.py`:
an immutable dataclass of positions plus optional colors, normals and
per-point packed covariances (needed by generalized ICP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class PointCloud:
    points: torch.Tensor                        # [N, 3]
    colors: Optional[torch.Tensor] = None       # [N, 3] in [0, 1]
    normals: Optional[torch.Tensor] = None      # [N, 3]
    covariances: Optional[torch.Tensor] = None  # [N, 6] packed symmetric

    def __len__(self) -> int:
        return int(self.points.shape[0])

    @property
    def num_points(self) -> int:
        return int(self.points.shape[0])

    def transform(self, T) -> "PointCloud":
        """Apply a 4x4 rigid transform to points, normals, covariances."""
        from gaussiansplattingregistration_tpu_torch.ops import math3d
        from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor

        T = as_tensor(T, self.points.device, self.points.dtype)
        R = T[:3, :3]
        new_points = self.points @ R.T + T[:3, 3]
        new_normals = None if self.normals is None else self.normals @ R.T
        new_cov = (
            None
            if self.covariances is None
            else math3d.transform_covariance(self.covariances, R)
        )
        return dataclasses.replace(
            self, points=new_points, normals=new_normals, covariances=new_cov
        )

    def select(self, indices) -> "PointCloud":
        """Gather a subset (counterpart of Open3D `select_by_index`)."""
        take = lambda a: None if a is None else a[indices]  # noqa: E731
        return PointCloud(
            points=self.points[indices],
            colors=take(self.colors),
            normals=take(self.normals),
            covariances=take(self.covariances),
        )

    def aabb(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.points.min(dim=0).values, self.points.max(dim=0).values
