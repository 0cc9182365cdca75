"""FPFH features (Fast Point Feature Histograms).

Torch counterpart of `gaussiansplattingregistration_tpu/ops/features.py`
(Open3D's `compute_fpfh_feature`, Rusu et al. 2009): 3 Darboux pair features
(alpha, phi, theta), 11 bins each -> 33-dim histograms; SPFH histograms are
percentage-normalized, FPFH(p) = SPFH(p) + (1/k) sum_i SPFH(q_i)/omega_i
with omega the neighbor distance.

Neighborhoods are the fixed-K hybrid search of `knn.hybrid_search` (radius
plus a max_nn cap). Histograms are one-hot sums, so a run gives the same
bits every time. The neighbor sum gathers SPFH rows in blocks of query
points, each [B, K, 33] gather within `knn.BLOCK_BYTES`, and contracts each
block with one batched product.

A pair feature within rounding of a bin edge may fall into either bin on the
card and on the CPU (`arctan2` and the f32 cross products differ in the last
bit): `near_bin_edge` names the points whose feature can move that way.
"""

from __future__ import annotations

import math

import torch

from gaussiansplattingregistration_tpu_torch.ops import knn as knn_ops

FPFH_BINS = 11
FPFH_DIM = 3 * FPFH_BINS
# (vmin, vmax) of alpha, phi, theta.
_RANGES = ((-1.0, 1.0), (-1.0, 1.0), (-math.pi, math.pi))


def _pair_features(p_s, n_s, p_t, n_t):
    """Darboux-frame pair features (alpha, phi, theta, d) for source point
    (p_s, n_s) and neighbor (p_t, n_t); all [..., 3] -> [...]."""
    dvec = p_t - p_s
    d = torch.linalg.norm(dvec, dim=-1)
    du = dvec / torch.clamp_min(d, 1e-12)[..., None]

    u = n_s.expand_as(du)
    v = torch.linalg.cross(du, u)
    v = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)
    w = torch.linalg.cross(u, v)

    alpha = torch.sum(v * n_t, dim=-1)
    phi = torch.sum(u * du, dim=-1)
    theta = torch.atan2(torch.sum(w * n_t, dim=-1), torch.sum(u * n_t, dim=-1))
    return alpha, phi, theta, d


def _scaled(values, vmin: float, vmax: float):
    return (values - vmin) / (vmax - vmin) * FPFH_BINS


def _histogram(values, vmin: float, vmax: float, weight):
    """One-hot histogram over FPFH_BINS bins. values [N, K] -> [N, BINS]."""
    bins = torch.clamp(torch.floor(_scaled(values, vmin, vmax)), 0, FPFH_BINS - 1).long()
    onehot = torch.nn.functional.one_hot(bins, FPFH_BINS).to(values.dtype)
    return torch.sum(onehot * weight[..., None], dim=1)


def _neighborhoods(points, radius: float, max_nn: int):
    """(d2, idx, valid) of the hybrid search, self-matches excluded."""
    n = points.shape[0]
    k = min(max_nn, n)
    d2, idx, valid = knn_ops.hybrid_search(points, points, radius, k)
    self_mask = idx == torch.arange(n, device=points.device)[:, None]
    return d2, idx, valid & ~self_mask


def compute_fpfh(
    points: torch.Tensor,
    normals: torch.Tensor,
    radius: float,
    max_nn: int = 100,
) -> torch.Tensor:
    """[N, 3] points + normals -> [N, 33] FPFH features, on their device.

    Defaults mirror Open3D's: radius = 5 * voxel_size, max_nn = 100."""
    d2, idx, valid = _neighborhoods(points, radius, max_nn)
    alpha, phi, theta, _ = _pair_features(points[:, None, :], normals[:, None, :],
                                          points[idx], normals[idx])

    vf = valid.to(points.dtype)
    counts = torch.clamp_min(torch.sum(vf, dim=1, keepdim=True), 1.0)
    # Percentage-normalized SPFH (PCL/Open3D hist_incr = 100/nn).
    incr = vf * (100.0 / counts)
    spfh = torch.cat([_histogram(f, lo, hi, incr)
                      for f, (lo, hi) in zip((alpha, phi, theta), _RANGES)], dim=-1)

    # FPFH = SPFH(p) + (1/k) sum SPFH(q_i) / ||p - q_i||.
    dist = torch.sqrt(torch.clamp_min(d2, 1e-12))
    w = torch.where(valid, 1.0 / torch.clamp_min(dist, 1e-6), 0.0)   # [N, K]
    rows = max(1, knn_ops.BLOCK_BYTES // (idx.shape[1] * FPFH_DIM * 4))
    neigh = torch.cat([
        torch.bmm(w[r:r + rows, None, :], spfh[idx[r:r + rows]])[:, 0]
        for r in range(0, points.shape[0], rows)
    ]) if points.shape[0] else spfh
    return spfh + neigh / counts


def near_bin_edge(
    points: torch.Tensor,
    normals: torch.Tensor,
    radius: float,
    max_nn: int = 100,
    tol: float = 1e-5,
) -> torch.Tensor:
    """[N] bool: points whose FPFH depends on a pair feature within `tol`
    (in feature units) of an interior bin edge, their own or a valid
    neighbor's (FPFH(p) sums its neighbors' SPFH). Only such a point's
    feature can land in another bin on another device."""
    _, idx, valid = _neighborhoods(points, radius, max_nn)
    feats = _pair_features(points[:, None, :], normals[:, None, :],
                           points[idx], normals[idx])[:3]
    edge = torch.zeros_like(valid)
    for f, (lo, hi) in zip(feats, _RANGES):
        s = _scaled(f, lo, hi)
        j = torch.round(s)
        edge |= (j >= 1) & (j <= FPFH_BINS - 1) & ((s - j).abs() * (hi - lo) / FPFH_BINS < tol)
    own = (edge & valid).any(dim=1)
    return own | (own[idx] & valid).any(dim=1)
