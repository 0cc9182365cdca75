"""Point-cloud normal estimation via local PCA (kNN plane fitting).

Torch counterpart of `gaussiansplattingregistration_tpu/ops/normals.py`
(Open3D's `estimate_normals(KDTreeSearchParamHybrid(...))`): for each point,
its k nearest neighbors within `radius`, the neighborhood covariance, and
the eigenvector of its smallest eigenvalue (batched `torch.linalg.eigh`),
oriented toward a reference direction (+z by default; a normal
perpendicular to it keeps its sign).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gaussiansplattingregistration_tpu_torch.ops import knn as knn_ops
from gaussiansplattingregistration_tpu_torch.ops import math3d
from gaussiansplattingregistration_tpu_torch.utils import profiling


def estimate_normals(
    points: torch.Tensor,
    k: int = 30,
    radius: float = math.inf,
    orientation_reference=None,
) -> torch.Tensor:
    """[N, 3] points -> [N, 3] unit normals, on the points' device. k=30 is
    the reference's `max_nn`; neighbors outside `radius` are left out of
    the covariance."""
    with profiling.span("normals.estimate"):
        k = min(k, points.shape[0])
        d2, idx = knn_ops.knn(points, points, k=k)
        w = (d2 <= radius * radius).to(points.dtype)[..., None]   # [N, k, 1]
        neigh = points[idx]                                       # [N, k, 3]
        count = torch.clamp_min(torch.sum(w, dim=1), 1.0)
        mean = torch.sum(neigh * w, dim=1) / count
        centered = (neigh - mean[:, None, :]) * w
        cov = torch.einsum("nki,nkj->nij", centered, centered) / count[..., None]
        _, vecs = math3d.symmetric_eigh(cov)
        normals = vecs[..., :, 0]
        if orientation_reference is None:
            ref = torch.tensor([0.0, 0.0, 1.0], dtype=points.dtype, device=points.device)
        else:
            ref = torch.as_tensor(orientation_reference, dtype=points.dtype, device=points.device)
        sign = torch.sign(torch.sum(normals * ref, dim=-1, keepdim=True))
        return normals * torch.where(sign == 0, 1.0, sign)


def with_estimated_normals(pc, k: int = 30, radius: float = math.inf):
    """A copy of a PointCloud with estimated normals attached."""
    return dataclasses.replace(pc, normals=estimate_normals(pc.points, k=k, radius=radius))
