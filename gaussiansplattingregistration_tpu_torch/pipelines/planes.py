"""Plane-inlier flows: registration on plane subsets + per-plane HEM merging.

Torch counterpart of `gaussiansplattingregistration_tpu/pipelines/planes.py`:

* `select_plane_inliers`: each cloud restricted to the concatenation of its
  plane-inlier index lists (Open3D's `select_by_index` on the level-0
  cloud), composed by the CLI's `register --plane-inliers-first/--second`
  and by `Workspace.inlier_pair`;
* `merge_plane_inliers`: per level, the points not on any plane pass
  through unchanged while each plane's inliers are HEM-downsampled on their
  own; the level-d result is unselected + plane-1 level d + plane-2 level d
  + ... (CLI: `merge-planes`).

Indices are int64 tensors on the cloud's device.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud
from gaussiansplattingregistration_tpu_torch.models.parameters import GaussianMixtureParams
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud


def load_plane_indices(path: str) -> List[np.ndarray]:
    """Read the per-plane inlier index lists from a `fit-planes --output`
    JSON ({"planes": ..., "inlier_indices": [[...], ...]})."""
    with open(path) as f:
        data = json.load(f)
    if "inlier_indices" not in data:
        raise ValueError(
            f"{path} has no 'inlier_indices' — produce it with `fit-planes --output`")
    return [np.asarray(ix, np.int64) for ix in data["inlier_indices"]]


def _index(ix, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ix, np.int64), device=device)


def select_plane_inliers(pc: PointCloud, plane_indices: Sequence[np.ndarray]) -> PointCloud:
    """The level-0 cloud restricted to the union of its plane inliers, in
    the order of the concatenated lists."""
    if not plane_indices:
        raise ValueError("no plane-inlier index lists")
    joined = np.concatenate([np.asarray(ix, np.int64) for ix in plane_indices])
    return pc.select(_index(joined, pc.points.device))


def merge_plane_inliers(
    cloud: GaussianCloud,
    plane_indices: Sequence[np.ndarray],
    params: GaussianMixtureParams,
    seed: int = 0,
    backend: str = "torch",
) -> List[GaussianCloud]:
    """Per-plane HEM merging of one Gaussian cloud, on its device.

    For each level d in 1..cluster_level the result is `unselected points
    (unchanged) + concat(HEM level d of each plane's inliers)`; plane p's
    mixture draws with seed `seed + p`. Returns `cluster_level`
    GaussianClouds (level 0, the input, is dropped)."""
    from gaussiansplattingregistration_tpu_torch.ops import hem as hem_ops

    if not plane_indices:
        raise ValueError("no plane-inlier index lists")
    dev = cloud.device
    n = cloud.num_points
    selected = np.concatenate([np.asarray(ix, np.int64) for ix in plane_indices])
    unselected = np.setdiff1d(np.arange(n), selected)
    base = cloud.select(_index(unselected, dev)) if unselected.size else None

    # Per-plane HEM pyramids (levels 1..cluster_level each).
    per_plane: List[List[GaussianCloud]] = []
    for p, ix in enumerate(plane_indices):
        sub = cloud.select(_index(ix, dev))
        levels = hem_ops.create_mixture(sub, params, seed=seed + p, backend=backend)
        per_plane.append(hem_ops.mixture_levels_to_clouds(levels, cloud.sh_degree, device=dev))

    out: List[GaussianCloud] = []
    for d in range(params.cluster_level):
        level: Optional[GaussianCloud] = base
        for clouds in per_plane:
            part = clouds[d]
            level = part if level is None else level.merge(part)
        out.append(level)
    return out
