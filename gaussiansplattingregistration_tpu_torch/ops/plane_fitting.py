"""Sequential RANSAC plane fitting.

Torch counterpart of `gaussiansplattingregistration_tpu/ops/plane_fitting.py`:
extract up to `plane_count` planes; per plane, `iterations` random 3-point
hypotheses (with a minimum pairwise sample distance), the plane from the
cross product, inliers = |point-plane distance| < threshold AND |normal .
plane normal| > normal_threshold; the hypothesis with the most inliers wins
(the first of tied counts, as `jnp.argmax` picks it); its inliers are
removed before the next round while original indices are tracked.

All hypotheses of a round are scored against every point, in blocks of
hypotheses whose [N, b] temporaries stay within `knn.BLOCK_BYTES` (at 1M
points and 300 hypotheses one unblocked temporary would take 1.2 GB). A
point's distance and alignment are sums of products in coordinate order,
so the card and the CPU count the same inliers. Sample draws come from a
`torch.Generator` seeded with `seed` on the points' device, or are injected
(`samples`), with which the JAX package's draws are reproduced. Also
provides `plane_grid_points`, display-mesh geometry for a fitted plane.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models.parameters import PlaneFittingParams
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.ops import knn as knn_ops
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor


def _dot3(x: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """[N, 3] x [b, 3] -> [N, b], ((x0 n0 + x1 n1) + x2 n2)."""
    acc = x[:, 0:1] * nrm[None, :, 0]
    acc += x[:, 1:2] * nrm[None, :, 1]
    acc += x[:, 2:3] * nrm[None, :, 2]
    return acc


def _inliers(points, normals, active, nrm, d, distance_threshold, normal_threshold):
    """[N, b] inlier mask of planes (nrm [b, 3], d [b])."""
    dist = _dot3(points, nrm).add_(d[None, :]).abs_() < distance_threshold
    align = _dot3(normals, nrm).abs_() > normal_threshold
    return dist & align & active[:, None]


def _draw_samples(generator, active: torch.Tensor, count: int) -> torch.Tensor:
    """`count` indices of active points, uniform with replacement (the
    distribution of the JAX package's `choice` with p = active / sum). An
    index into the active points' list: `torch.multinomial` refuses more
    than 2^24 categories."""
    pool = torch.nonzero(active)[:, 0]
    pick = torch.randint(0, pool.shape[0], (count,), generator=generator, device=active.device)
    return pool[pick]


def _fit_single_plane(
    generator,
    points: torch.Tensor,
    normals: torch.Tensor,
    active: torch.Tensor,
    distance_threshold: float,
    normal_threshold: float,
    min_sample_distance: float,
    iterations: int,
    samples: Optional[torch.Tensor] = None,
):
    """Best plane over `iterations` hypotheses. `samples` ([iterations, 3]
    point indices) replaces the draw from `generator`.

    Returns (plane [4], inlier_mask [N], inlier_count), on the points'
    device."""
    n = points.shape[0]
    dev = points.device
    if samples is None:
        # Hypotheses violating the min-pairwise-distance constraint are
        # discarded, not redrawn.
        samples = _draw_samples(generator, active, iterations * 3).reshape(iterations, 3)
    samples = as_tensor(samples, dev, torch.int64)
    p1, p2, p3 = points[samples[:, 0]], points[samples[:, 1]], points[samples[:, 2]]
    sample_ok = ((torch.linalg.norm(p1 - p2, dim=-1) >= min_sample_distance)
                 & (torch.linalg.norm(p1 - p3, dim=-1) >= min_sample_distance)
                 & (torch.linalg.norm(p2 - p3, dim=-1) >= min_sample_distance))
    nrm = torch.linalg.cross(p2 - p1, p3 - p1)
    nn = torch.linalg.norm(nrm, dim=-1)
    nrm = nrm / torch.clamp_min(nn, 1e-12)[:, None]
    d = -torch.sum(nrm * p1, dim=-1)

    block = max(1, knn_ops.BLOCK_BYTES // (4 * max(n, 1)))
    counts = torch.cat([
        torch.sum(_inliers(points, normals, active, nrm[b:b + block], d[b:b + block],
                           distance_threshold, normal_threshold), dim=0)
        for b in range(0, samples.shape[0], block)])
    counts = torch.where(sample_ok & (nn > 1e-12), counts, -1)
    best = torch.argmax(counts)        # the first maximum, as jnp.argmax
    plane = torch.cat([nrm[best], d[best, None]])
    inliers = _inliers(points, normals, active, nrm[best, None], d[best, None],
                       distance_threshold, normal_threshold)[:, 0]
    return plane, inliers, counts[best]


def fit_planes(
    pc: PointCloud,
    params: PlaneFittingParams,
    seed: int = 0,
    samples: Optional[Sequence] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Sequential multi-plane RANSAC on the cloud's device. Returns (plane
    coefficients [4] list, original-inlier-index arrays), host numpy.
    `samples`, one [iterations, 3] index array per plane, replaces the
    generator's draws."""
    if pc.normals is None:
        from gaussiansplattingregistration_tpu_torch.ops import normals as normals_ops

        pc = normals_ops.with_estimated_normals(pc)

    dev = pc.points.device
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    active = torch.ones(pc.num_points, dtype=torch.bool, device=dev)
    coefficients, inlier_lists = [], []
    for p in range(params.plane_count):
        plane, inliers, count = _fit_single_plane(
            generator, pc.points, pc.normals, active,
            params.distance_threshold, params.normal_threshold, params.min_distance,
            int(params.iterations),
            samples=None if samples is None else samples[p],
        )
        if int(count) <= 0:
            break
        coefficients.append(plane.cpu().numpy())
        inlier_lists.append(np.flatnonzero(inliers.cpu().numpy()))
        active = active & ~inliers
        if int(torch.sum(active)) == 0:
            break
    return coefficients, inlier_lists


def project_points_onto_plane(points: torch.Tensor, plane: torch.Tensor):
    """Returns (projected points, signed distances)."""
    nrm = plane[:3] / torch.clamp_min(torch.linalg.norm(plane[:3]), 1e-12)
    dists = points @ nrm + plane[3]
    return points - dists[:, None] * nrm, dists


def plane_grid_points(
    plane: np.ndarray, points: np.ndarray, resolution: int = 10
) -> Tuple[np.ndarray, np.ndarray]:
    """Display-mesh geometry for a fitted plane (host numpy, a copy of the
    JAX package's): returns (vertices [res*res, 3], double-sided triangle
    index list [M, 3])."""
    a, b, c, d = [float(v) for v in plane]
    nrm = np.array([a, b, c], dtype=np.float32)
    nrm /= max(np.linalg.norm(nrm), 1e-12)
    points = np.asarray(points)
    dists = points @ nrm + d
    projected = points - dists[:, None] * nrm

    u = np.array([-b, a, 0.0], dtype=np.float32)
    if np.linalg.norm(u) == 0:
        u = np.array([1.0, 0.0, 0.0], dtype=np.float32)
    u /= np.linalg.norm(u)
    v = np.cross(nrm, u)

    coords = np.stack([projected @ u, projected @ v], axis=-1)
    lo, hi = coords.min(0), coords.max(0)
    xs = np.linspace(lo[0], hi[0], resolution)
    ys = np.linspace(lo[1], hi[1], resolution)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    verts = (X[..., None] * u + Y[..., None] * v).reshape(-1, 3)
    verts += nrm * (-d)

    tris = []
    for i in range(resolution - 1):
        for j in range(resolution - 1):
            idx = i * resolution + j
            tris.append([idx, idx + resolution, idx + 1])
            tris.append([idx + resolution, idx + resolution + 1, idx + 1])
    tris += [[t[2], t[1], t[0]] for t in tris]
    return verts.astype(np.float32), np.asarray(tris, np.int32)
