"""Global registration: FPFH + RANSAC feature matching, and FGR.

Torch counterpart of `gaussiansplattingregistration_tpu/ops/global_registration.py`
(Open3D's `registration_ransac_based_on_feature_matching` and
`registration_fgr_based_on_feature_matching`):

* `preprocess_point_cloud`: voxel downsample -> normals (2x voxel radius,
  nn=30) -> FPFH (5x voxel radius, nn=100);
* `ransac_registration`: feature correspondences (nearest neighbor in the
  33-dim FPFH space, `knn`'s Gram form with TF32 off), optional mutual
  filter, hypotheses in batches (batched Kabsch on ransac_n samples) with
  Open3D's correspondence checkers (edge length, distance, normal) and its
  confidence exit;
* `fgr_registration`: Fast Global Registration (Zhou et al. 2016) —
  mutual-nearest feature correspondences and the tuple test, then graduated
  non-convexity over the scaled Geman-McClure penalty, mu divided every 4
  iterations.

What differs from the JAX package, by design:
* draws come from a `torch.Generator` seeded with `seed` on the points'
  device; CPU, CUDA and `jax.random` streams differ for one seed, so
  `_eval_hypotheses`, `ransac_registration`, `_tuple_test` take injected
  draws, with which the two packages agree;
* the RANSAC search is a Python loop over batches with one host read per
  batch (the confidence exit), where JAX runs an on-device while_loop;
  FGR's iterations read nothing until the end.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from gaussiansplattingregistration_tpu_torch.models.parameters import (
    FGRRegistrationParams,
    RANSACRegistrationParams,
)
from gaussiansplattingregistration_tpu_torch.models.point_cloud import PointCloud
from gaussiansplattingregistration_tpu_torch.models.registration_data import RegistrationResult
from gaussiansplattingregistration_tpu_torch.ops import features as feat_ops
from gaussiansplattingregistration_tpu_torch.ops import knn as knn_ops
from gaussiansplattingregistration_tpu_torch.ops import math3d
from gaussiansplattingregistration_tpu_torch.ops import normals as normals_ops
from gaussiansplattingregistration_tpu_torch.ops.voxel import voxel_downsample
from gaussiansplattingregistration_tpu_torch.utils.device import as_tensor


def preprocess_point_cloud(pc: PointCloud, voxel_size: float) -> Tuple[PointCloud, torch.Tensor]:
    """Downsample + estimate normals + FPFH, on the cloud's device."""
    down = voxel_downsample(pc, voxel_size)
    down = dataclasses.replace(
        down, normals=normals_ops.estimate_normals(down.points, k=30, radius=voxel_size * 2.0))
    fpfh = feat_ops.compute_fpfh(down.points, down.normals, radius=voxel_size * 5.0, max_nn=100)
    return down, fpfh


def _feature_correspondences(src_feat: torch.Tensor, tgt_feat: torch.Tensor, mutual_filter: bool):
    """Nearest neighbor in feature space; returns (tgt index per src point,
    keep mask)."""
    _, idx_st = knn_ops.nearest_neighbor(src_feat, tgt_feat)
    if not mutual_filter:
        return idx_st, torch.ones(src_feat.shape[0], dtype=torch.bool, device=src_feat.device)
    _, idx_ts = knn_ops.nearest_neighbor(tgt_feat, src_feat)
    keep = idx_ts[idx_st] == torch.arange(src_feat.shape[0], device=src_feat.device)
    return idx_st, keep


def _kabsch(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rigid transforms from paired points, [B, n, 3] x [B, n, 3] -> [B, 4, 4].
    The centroids are sums times the f32 reciprocal of n, as XLA computes
    jnp.mean: where the n points coincide (an empty keep mask samples index
    0 n times) H is rounding noise, and the rotation follows that noise."""
    inv_n = 1.0 / p.shape[1]
    p_bar = torch.sum(p, dim=1, keepdim=True) * inv_n
    q_bar = torch.sum(q, dim=1, keepdim=True) * inv_n
    H = torch.einsum("bni,bnj->bij", p - p_bar, q - q_bar)
    R = math3d.kabsch_rotation(H)
    t = q_bar[:, 0] - torch.einsum("bij,bj->bi", R, p_bar[:, 0])
    return math3d.make_se3(R, t)


def _apply(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x [..., n, 3] under transforms T [..., 4, 4]: x R^T + t."""
    return x @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def _eval_hypotheses(
    generator,
    src_pts, tgt_pts, src_normals, tgt_normals,
    corr_idx, corr_mask,
    max_correspondence: float,
    ransac_n: int,
    batch: int,
    checker_kinds: tuple,
    checker_values: tuple,
    samples: Optional[torch.Tensor] = None,
):
    """Evaluate `batch` RANSAC hypotheses; returns (fitness [B], rmse [B],
    T [B, 4, 4]). `samples` ([batch, ransac_n] correspondence indices)
    replaces the draw from `generator`."""
    dev = src_pts.device
    if samples is None:
        # With replacement, in proportion to the keep mask. An empty mask
        # gives every sample index 0, as jax.random.choice does with p = 0
        # everywhere; the generator is consumed as for a uniform draw
        # either way, so no host read decides it.
        any_kept = corr_mask.any()
        probs = torch.where(any_kept, corr_mask.to(torch.float32), 1.0)
        samples = torch.multinomial(probs, batch * ransac_n, replacement=True,
                                    generator=generator).reshape(batch, ransac_n)
        samples = torch.where(any_kept, samples, 0)
    samples = as_tensor(samples, dev, torch.int64)
    p = src_pts[samples]                      # [B, n, 3]
    q = tgt_pts[corr_idx[samples]]            # [B, n, 3]
    T = _kabsch(p, q)

    ok = torch.ones(samples.shape[0], dtype=torch.bool, device=dev)
    for kind, val in zip(checker_kinds, checker_values):
        val = torch.tensor(val, dtype=torch.float32, device=dev)
        if kind == "edge_length":
            # ||pi-pj|| vs ||qi-qj|| within factor `val` both ways.
            iu = torch.triu_indices(ransac_n, ransac_n, offset=1, device=dev)
            e1 = torch.linalg.norm(p[:, iu[0]] - p[:, iu[1]], dim=-1)
            e2 = torch.linalg.norm(q[:, iu[0]] - q[:, iu[1]], dim=-1)
            ok &= torch.all((e1 >= val * e2) & (e2 >= val * e1), dim=1)
        elif kind == "distance":
            ok &= torch.all(torch.linalg.norm(_apply(T, p) - q, dim=-1) <= val, dim=1)
        elif kind == "normal":
            ns = src_normals[samples] @ T[:, :3, :3].transpose(-1, -2)
            nt = tgt_normals[corr_idx[samples]]
            ok &= torch.all(torch.sum(ns * nt, dim=-1) >= torch.cos(val), dim=1)
        else:
            raise ValueError(f"unknown correspondence checker {kind!r}")

    # Score every hypothesis over the full correspondence set, in blocks of
    # hypotheses whose [b, n_src, 3] temporaries stay within BLOCK_BYTES.
    tgt_c = tgt_pts[corr_idx]
    n_corr = torch.clamp_min(torch.sum(corr_mask), 1)
    rows = max(1, knn_ops.BLOCK_BYTES // (12 * max(src_pts.shape[0], 1)))
    counts, sq = [], []
    for b0 in range(0, T.shape[0], rows):
        d = torch.linalg.norm(_apply(T[b0:b0 + rows], src_pts[None]) - tgt_c, dim=-1)
        inlier = (d <= max_correspondence) & corr_mask
        counts.append(torch.sum(inlier, dim=1))
        sq.append(torch.sum(torch.where(inlier, d * d, 0.0), dim=1))
    count, sq = torch.cat(counts), torch.cat(sq)
    fitness = torch.where(ok, count / n_corr, -1.0)
    rmse = torch.sqrt(sq / torch.clamp_min(count, 1))
    return fitness, rmse, T


def _ransac_search(
    generator,
    src_pts, tgt_pts, src_normals, tgt_normals,
    corr_idx, corr_mask,
    max_correspondence: float,
    confidence: float,
    ransac_n: int,
    batch: int,
    max_batches: int,
    checker_kinds: tuple,
    checker_values: tuple,
    samples: Optional[Iterable] = None,
):
    """Batches of hypotheses until max_batches * batch have run or Open3D's
    confidence bound 1 - (1 - fitness^n)^total reaches `confidence`; one
    host read per batch. The bound is evaluated in float32, as in the JAX
    package, so the loop exits after the same batch. Returns (best_f,
    best_r, best_T, total) with best_* device scalars."""
    dev = src_pts.device
    best_f = torch.tensor(-1.0, device=dev)
    best_r = torch.tensor(float("inf"), device=dev)
    best_T = torch.eye(4, device=dev)
    total = 0
    draws = None if samples is None else iter(samples)
    while total < max_batches * batch:
        injected = None if draws is None else next(draws, None)
        if draws is not None and injected is None:
            raise ValueError(f"injected samples ran out after {total // batch} batches")
        fitness, rmse, Ts = _eval_hypotheses(
            generator, src_pts, tgt_pts, src_normals, tgt_normals, corr_idx, corr_mask,
            max_correspondence, ransac_n, batch, checker_kinds, checker_values,
            samples=injected)
        i = torch.argmax(fitness)      # the first maximum, as jnp.argmax
        f_i, r_i = fitness[i], rmse[i]
        better = (f_i > best_f) | ((f_i == best_f) & (r_i < best_r))
        best_f = torch.where(better, f_i, best_f)
        best_r = torch.where(better, r_i, best_r)
        best_T = torch.where(better, Ts[i], best_T)
        total += batch
        base = 1.0 - torch.clamp(best_f, 0.0, 1.0) ** ransac_n
        p_success = 1.0 - base ** torch.tensor(float(total), device=dev)
        if bool((best_f > 0) & (p_success >= confidence)):
            break
    return best_f, best_r, best_T, total


def _checker_spec(params: RANSACRegistrationParams):
    return (tuple(c.kind for c in params.checkers),
            tuple(float(c.value) for c in params.checkers))


def ransac_registration(
    source: PointCloud,
    target: PointCloud,
    params: RANSACRegistrationParams,
    seed: int = 0,
    batch: int = 512,
    samples: Optional[Iterable] = None,
) -> RegistrationResult:
    """FPFH + RANSAC global registration on the clouds' device.

    Hypotheses run in batches of `batch`; iteration stops at
    `max_iteration` hypotheses (rounded up to whole batches) or once the
    confidence bound is reached. `num_iterations` is the number of
    hypotheses evaluated. `samples`, one [batch, ransac_n] index array per
    batch, replaces the generator's draws."""
    src_down, src_fpfh = preprocess_point_cloud(source, params.voxel_size)
    tgt_down, tgt_fpfh = preprocess_point_cloud(target, params.voxel_size)
    corr_idx, corr_mask = _feature_correspondences(src_fpfh, tgt_fpfh, params.mutual_filter)
    generator = torch.Generator(device=source.points.device)
    generator.manual_seed(seed)
    best_f, best_r, best_T, total = _ransac_search(
        generator, src_down.points, tgt_down.points, src_down.normals, tgt_down.normals,
        corr_idx, corr_mask, float(params.max_correspondence), float(params.confidence),
        int(params.ransac_n), int(batch), max(1, -(-int(params.max_iteration) // int(batch))),
        *_checker_spec(params), samples=samples)
    best_f, best_r = float(best_f), float(best_r)
    return RegistrationResult(
        transformation=best_T.cpu().numpy().astype(np.float64),
        fitness=max(best_f, 0.0),
        inlier_rmse=best_r if np.isfinite(best_r) else 0.0,
        num_iterations=int(total),
        converged=best_f > 0,
    )


# --------------------------------------------------------------------------
# Fast Global Registration (Zhou, Park, Koltun 2016)
# --------------------------------------------------------------------------

def _tuple_test(generator, src_c, tgt_c, tuple_scale: float, max_tuple_count: int,
                idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FGR tuple test: random correspondence triples must have consistent
    edge-length ratios; returns a keep mask over correspondences. `idx`
    ([max_tuple_count, 3]) replaces the draw from `generator`."""
    m = src_c.shape[0]
    dev = src_c.device
    if idx is None:
        idx = torch.randint(0, m, (max_tuple_count, 3), generator=generator, device=dev)
    idx = as_tensor(idx, dev, torch.int64)
    p, q = src_c[idx], tgt_c[idx]                           # [T, 3, 3]

    def edges(x):
        return torch.linalg.norm(x - x[:, [1, 2, 0]], dim=-1)

    ep, eq = edges(p), edges(q)
    scale = torch.tensor(tuple_scale, dtype=torch.float32, device=dev)
    tuple_ok = torch.all((ep > scale * eq) & (eq > scale * ep), dim=-1)   # [T]
    keep = torch.zeros(m, dtype=torch.bool, device=dev)
    # The JAX scatter-max of the triples' flags, order-free: every index of
    # a passing triple is kept.
    keep[idx[tuple_ok].reshape(-1)] = True
    return keep


def _fgr_optimize(src_c, tgt_c, mask, max_corr: float, division_factor: float,
                  max_iterations: int, decrease_mu: bool):
    """Graduated non-convexity over scaled Geman-McClure line processes:
    `max_iterations` weighted Kabsch updates, no host read. Returns (T,
    fitness, rmse) as device tensors."""
    dev = src_c.device
    max_corr = torch.tensor(max_corr, dtype=torch.float32, device=dev)
    division_factor = torch.tensor(division_factor, dtype=torch.float32, device=dev)
    mu = torch.clamp_min(max_corr * max_corr * 64.0, 1e-6)
    T = torch.eye(4, device=dev)
    for it in range(max_iterations):
        p = _apply(T, src_c)
        r2 = torch.sum((p - tgt_c) ** 2, dim=-1)
        w = (mu / (mu + r2)) ** 2 * mask
        # Weighted Kabsch update toward the current line-process weights.
        wsum = torch.clamp_min(torch.sum(w), 1e-9)
        p_bar = torch.sum(p * w[:, None], dim=0) / wsum
        q_bar = torch.sum(tgt_c * w[:, None], dim=0) / wsum
        H = ((p - p_bar) * w[:, None]).T @ (tgt_c - q_bar)
        R = math3d.kabsch_rotation(H)
        T = math3d.make_se3(R, q_bar - R @ p_bar) @ T
        if decrease_mu and it % 4 == 3:
            mu = torch.maximum(mu / division_factor, max_corr * max_corr)
    d = torch.linalg.norm(_apply(T, src_c) - tgt_c, dim=-1)
    inlier = (d <= max_corr) & (mask > 0)
    n_in = torch.sum(inlier)
    fitness = n_in / torch.clamp_min(torch.sum(mask), 1)
    rmse = torch.sqrt(torch.sum(torch.where(inlier, d * d, 0.0)) / torch.clamp_min(n_in, 1))
    return T, fitness, rmse


def fgr_registration(
    source: PointCloud,
    target: PointCloud,
    params: FGRRegistrationParams,
    seed: int = 0,
    idx: Optional[torch.Tensor] = None,
) -> RegistrationResult:
    """Fast Global Registration on the clouds' device. `idx` replaces the
    tuple test's draw."""
    src_down, src_fpfh = preprocess_point_cloud(source, params.voxel_size)
    tgt_down, tgt_fpfh = preprocess_point_cloud(target, params.voxel_size)

    # Mutual nearest correspondences (FGR's reciprocity test).
    idx_st, keep = _feature_correspondences(src_fpfh, tgt_fpfh, mutual_filter=True)
    src_c = src_down.points
    tgt_c = tgt_down.points[idx_st]
    if params.tuple_test:
        generator = torch.Generator(device=src_c.device)
        generator.manual_seed(seed)
        keep = keep & _tuple_test(generator, src_c, tgt_c, float(params.tuple_scale),
                                  int(params.max_tuple_count), idx=idx)

    scale = 1.0
    if not params.use_absolute_scale:
        # FGR normalizes by the point-cloud spread unless absolute scale is on.
        span = torch.maximum(
            torch.linalg.norm(src_c.max(0).values - src_c.min(0).values),
            torch.linalg.norm(tgt_down.points.max(0).values - tgt_down.points.min(0).values))
        scale = float(span)

    T, fitness, rmse = _fgr_optimize(
        src_c, tgt_c, keep.to(torch.float32), params.maximum_correspondence * scale,
        float(params.division_factor), int(params.max_iterations), bool(params.decrease_mu))
    return RegistrationResult(
        transformation=T.cpu().numpy().astype(np.float64),
        fitness=float(fitness),
        inlier_rmse=float(rmse),
        num_iterations=int(params.max_iterations),
        converged=True,
    )
